// Modular arithmetic on residues in one machine word, for Hopper (sm_90a).
//
// The CUDA counterpart of hexl_tpu_torch/limb.py and of the JAX package's
// hexl_tpu/limb.py: exact Shoup and Barrett with the hardware's multiplies
// (__umul64hi, or __umulhi for the single-word regime of q < 2^30), the
// range halver, and the exact Harvey butterflies of hexl_tpu/ntt/jnp_ntt.py
// (_fwd_butterfly, _inv_butterfly, _final_inv_stage_fin) and of
// hexl_tpu/ntt/ntt32.py (_fwd_bfly, _inv_bfly, _shoup32). The butterflies
// are templates on the word type W (u64, or u32 when every lazy value
// < 4q < 2^32); every function is bit-identical to its plain PyTorch
// version, lazy ranges included.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

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

// Harvey forward butterfly: inputs [0, 4q) -> outputs [0, 4q).
template <typename W>
__device__ __forceinline__ void fwd_butterfly(W& x, W& y, W w, W wp, W q,
                                              W two_q) {
  const W tx = halve(x, two_q);
  const W t = shoup(y, w, wp, q);
  x = tx + t;
  y = tx + two_q - t;
}

// Harvey inverse butterfly: inputs [0, 2q) -> outputs [0, 2q).
template <typename W>
__device__ __forceinline__ void inv_butterfly(W& x, W& y, W w, W wp, W q,
                                              W two_q) {
  const W tx = halve((W)(x + y), two_q);
  const W ty = x + two_q - y;
  x = tx;
  y = shoup(ty, w, wp, q);
}

// The inverse transform's last stage fused with the scale by N^-1:
// outputs in [0, 2q). The preconditions are at 2^64 for W = u64 and at
// 2^32 for W = u32.
template <typename W>
struct InvFinal {
  W inv_n, inv_n_precon, inv_n_w, inv_n_w_precon;
};

template <typename W>
__device__ __forceinline__ void inv_final_butterfly(W& x, W& y,
                                                    const InvFinal<W>& f,
                                                    W q, W two_q) {
  const W tx = halve((W)(x + y), two_q);
  const W ty = x + two_q - y;
  x = shoup(tx, f.inv_n, f.inv_n_precon, q);
  y = shoup(ty, f.inv_n_w, f.inv_n_w_precon, q);
}
