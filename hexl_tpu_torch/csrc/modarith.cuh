// Modular arithmetic on residues in one machine word, for Hopper (sm_90a).
//
// The CUDA counterpart of hexl_tpu_torch/limb.py and of the JAX package's
// hexl_tpu/limb.py: exact Shoup and Barrett with the hardware's multiplies
// (__umul64hi, or __umulhi for the single-word regime of q < 2^30), the
// range halver, and the butterflies of hexl_tpu/ntt/jnp_ntt.py: the exact
// Harvey ones (_fwd_butterfly, _inv_butterfly, _final_inv_stage_fin), also
// those of hexl_tpu/ntt/ntt32.py (_fwd_bfly, _inv_bfly, _shoup32), and the
// approximate-quotient ones of the JAX engine's device bodies
// (_fwd_butterfly_lean16/_lean8, _inv_butterfly_lean8/_lean4,
// _final_inv_stage_lean8/_lean4, _fwd_fixup), whose Shoup quotient is
// mulhi64_approx6 (hexl_tpu/limb.py), computed op for op. The butterflies
// are templates on the word type W (u64, or u32 when every lazy value
// < 4q < 2^32) and on the scheme S (a compile-time tag, so that no form
// costs another registers; the lean schemes are u64 only); every function
// is bit-identical to its plain PyTorch version
// (hexl_tpu_torch/ntt/torch_ntt.py), lazy ranges included.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

// The butterfly schemes (hexl_tpu_torch/ntt/torch_ntt.py SCHEMES; the C
// entries take these codes): exact Harvey; lean16 (q < 2^60: forward
// invariant [0, 16q), inverse [0, 8q), one halver a butterfly); lean8
// (q < 2^61: forward [0, 8q), inverse [0, 4q), two halvers).
enum Scheme : int { EXACT = 0, LEAN16 = 1, LEAN8 = 2 };

// C, the additive constant of a scheme's invariant, as a multiple of q: the
// halvers' bound and what Y' = X + C - T adds, in both directions.
template <int S>
__host__ __device__ constexpr int wide_factor() {
  return S == LEAN16 ? 8 : S == LEAN8 ? 4 : 2;
}

// x >= c ? x - c : x, requiring x < c + 2^63 and c <= 2^63: the wrapped
// difference is negative as a signed value exactly when x < c.
__device__ __forceinline__ u64 halve(u64 x, u64 c) {
  const u64 d = x - c;
  return (long long)d < 0 ? x : d;
}

__device__ __forceinline__ u32 halve(u32 x, u32 c) {
  return x >= c ? x - c : x;
}

// x mod q for x < imf*q, imf in {1, 2, 4}.
template <typename W>
__device__ __forceinline__ W reduce_lazy(W x, W q, int imf) {
  if (imf >= 4) x = halve(x, (W)(2 * q));
  if (imf >= 2) x = halve(x, q);
  return x;
}

// x mod q for x < imf*q, imf in {1, 2, 4, 8} (8q must fit the word).
template <typename W>
__device__ __forceinline__ W reduce_lazy8(W x, W q, int imf) {
  if (imf >= 8) x = halve(x, (W)(4 * q));
  return reduce_lazy(x, q, imf);
}

// Any u64 mod q by Barrett with q_barr = floor(2^64 / q): [0, 2q), or
// [0, q) for omf 1.
__device__ __forceinline__ u64 barrett_reduce(u64 x, u64 q, u64 q_barr,
                                              int omf) {
  const u64 r = x - __umul64hi(x, q_barr) * q;
  return omf == 1 ? halve(r, q) : r;
}

// (x * w) mod q in [0, 2q), w_precon = floor(w * 2^64 / q).
__device__ __forceinline__ u64 shoup(u64 x, u64 w, u64 w_precon, u64 q) {
  const u64 q_hat = __umul64hi(x, w_precon);
  return x * w - q_hat * q;
}

// The single-word form: (x * w) mod q in [0, 2q) for q < 2^30 and any
// x < 2^32, w_precon = floor(w * 2^32 / q), the difference taken mod 2^32.
__device__ __forceinline__ u32 shoup(u32 x, u32 w, u32 w_precon, u32 q) {
  const u32 q_hat = __umulhi(x, w_precon);
  return x * w - q_hat * q;
}

// The high 32 bits of a * b less 0, 1 or 2 (hexl_tpu/limb.py::hi32_approx):
// three 16-bit partial products, the middle column's carry dropped.
__device__ __forceinline__ u32 hi32_approx(u32 a, u32 b) {
  const u32 a0 = a & 0xFFFFu, a1 = a >> 16;
  const u32 b0 = b & 0xFFFFu, b1 = b >> 16;
  return a1 * b1 + ((a0 * b1) >> 16) + ((a1 * b0) >> 16);
}

// floor(x * y / 2^64) - e, e in [0, 6] (hexl_tpu/limb.py::mulhi64_approx6):
// the bit-32 column dropped, the cross partials' high halves from
// hi32_approx. The JAX form's two 32-bit carries are this 64-bit sum's.
__device__ __forceinline__ u64 mulhi64_approx6(u64 x, u64 y) {
  const u32 x0 = (u32)x, x1 = (u32)(x >> 32);
  const u32 y0 = (u32)y, y1 = (u32)(y >> 32);
  return (u64)x1 * y1 + hi32_approx(x0, y1) + hi32_approx(x1, y0);
}

// (x * y) mod q for x, y in [0, q), q < 2^62, output in [0, q):
// c1 = (x*y) >> shift, q_hat = mulhi(c1, mu), z = x*y - q_hat*q in [0, 2q)
// with mu = floor(2^(bits(q)+62) / q) and shift = bits(q) - 2.
__device__ __forceinline__ u64 mult_mod_barrett(u64 x, u64 y, u64 q, u64 mu,
                                                int shift) {
  const u64 lo = x * y;
  const u64 hi = __umul64hi(x, y);
  const u64 c1 = shift == 0 ? lo : (lo >> shift) | (hi << (64 - shift));
  const u64 q_hat = __umul64hi(c1, mu);
  return halve(lo - q_hat * q, q);
}

// The butterflies' twiddle product T of a scheme: the exact Shoup product,
// [0, 2q); lean16's raw approximate one, [0, 8q) for any 64-bit x; lean8's
// halved once, [0, 4q).
template <typename W, int S>
__device__ __forceinline__ W bfly_product(W x, W w, W wp, W q) {
  if constexpr (S == EXACT) {
    return shoup(x, w, wp, q);
  } else {
    static_assert(sizeof(W) == 8, "the lean schemes are 64-bit only");
    const W r = x * w - mulhi64_approx6(x, wp) * q;
    if constexpr (S == LEAN8) return halve(r, 4 * q);
    return r;
  }
}

// Forward butterfly: X' = red(X) + T, Y' = red(X) + C - T. Exact: inputs
// [0, 4q) -> outputs [0, 4q) (Harvey); lean16 [0, 16q); lean8 [0, 8q).
// two_q is the exact scheme's C; the lean ones form theirs from q.
template <typename W, int S = EXACT>
__device__ __forceinline__ void fwd_butterfly(W& x, W& y, W w, W wp, W q,
                                              W two_q) {
  const W wide = S == EXACT ? two_q : (W)wide_factor<S>() * q;
  const W tx = halve(x, wide);
  const W t = bfly_product<W, S>(y, w, wp, q);
  x = tx + t;
  y = tx + wide - t;
}

// Inverse butterfly: X' = red(X + Y), Y' = (X + C - Y) W. Exact: inputs
// [0, 2q) -> outputs [0, 2q) (Harvey); lean16 [0, 8q); lean8 [0, 4q).
template <typename W, int S = EXACT>
__device__ __forceinline__ void inv_butterfly(W& x, W& y, W w, W wp, W q,
                                              W two_q) {
  const W wide = S == EXACT ? two_q : (W)wide_factor<S>() * q;
  const W tx = halve((W)(x + y), wide);
  const W ty = x + wide - y;
  x = tx;
  y = bfly_product<W, S>(ty, w, wp, q);
}

// A lean forward's output back to the OMF 4 contract [0, 4q)
// (jnp_ntt.py::_fwd_fixup): two halvers after lean16, one after lean8.
template <typename W, int S>
__device__ __forceinline__ W fwd_fixup(W x, W q) {
  if constexpr (S == LEAN16) x = halve(x, (W)(8 * q));
  if constexpr (S != EXACT) x = halve(x, (W)(4 * q));
  return x;
}

// The inverse transform's last stage fused with the scale by N^-1:
// outputs in [0, 2q). The preconditions are at 2^64 for W = u64 and at
// 2^32 for W = u32.
template <typename W>
struct InvFinal {
  W inv_n, inv_n_precon, inv_n_w, inv_n_w_precon;
};

// A lean scheme's inputs lie in [0, C) and need no halver before the exact
// Shoup products, which take any 64-bit value (_final_inv_stage_lean8 for
// lean16, _lean4 for lean8).
template <typename W, int S = EXACT>
__device__ __forceinline__ void inv_final_butterfly(W& x, W& y,
                                                    const InvFinal<W>& f,
                                                    W q, W two_q) {
  const W wide = S == EXACT ? two_q : (W)wide_factor<S>() * q;
  const W sum = x + y;
  const W tx = S == EXACT ? halve(sum, wide) : sum;
  const W ty = x + wide - y;
  x = shoup(tx, f.inv_n, f.inv_n_precon, q);
  y = shoup(ty, f.inv_n_w, f.inv_n_w_precon, q);
}
