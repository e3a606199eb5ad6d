// Modular arithmetic on u64 residues for Hopper (sm_90a).
//
// The CUDA counterpart of hexl_tpu_torch/limb.py and of the JAX package's
// hexl_tpu/limb.py: exact Shoup and Barrett with the hardware's 64-bit
// multiply (__umul64hi for the high half), the sign-test range halver, and
// the exact Harvey butterflies of hexl_tpu/ntt/jnp_ntt.py (_fwd_butterfly,
// _inv_butterfly, _final_inv_stage_fin). Every function is bit-identical
// to its plain PyTorch version, lazy ranges included.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

// x >= c ? x - c : x, requiring x < c + 2^63 and c <= 2^63: the wrapped
// difference is negative as a signed value exactly when x < c.
__device__ __forceinline__ u64 halve(u64 x, u64 c) {
  const u64 d = x - c;
  return (long long)d < 0 ? x : d;
}

// x mod q for x < imf*q, imf in {1, 2, 4}.
__device__ __forceinline__ u64 reduce_lazy(u64 x, u64 q, int imf) {
  if (imf >= 4) x = halve(x, 2 * q);
  if (imf >= 2) x = halve(x, q);
  return x;
}

// (x * w) mod q in [0, 2q), w_precon = floor(w * 2^64 / q).
__device__ __forceinline__ u64 shoup(u64 x, u64 w, u64 w_precon, u64 q) {
  const u64 q_hat = __umul64hi(x, w_precon);
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
__device__ __forceinline__ void fwd_butterfly(u64& x, u64& y, u64 w, u64 wp,
                                              u64 q, u64 two_q) {
  const u64 tx = halve(x, two_q);
  const u64 t = shoup(y, w, wp, q);
  x = tx + t;
  y = tx + two_q - t;
}

// Harvey inverse butterfly: inputs [0, 2q) -> outputs [0, 2q).
__device__ __forceinline__ void inv_butterfly(u64& x, u64& y, u64 w, u64 wp,
                                              u64 q, u64 two_q) {
  const u64 tx = halve(x + y, two_q);
  const u64 ty = x + two_q - y;
  x = tx;
  y = shoup(ty, w, wp, q);
}

// The inverse transform's last stage fused with the scale by N^-1:
// outputs in [0, 2q).
struct InvFinal {
  u64 inv_n, inv_n_precon, inv_n_w, inv_n_w_precon;
};

__device__ __forceinline__ void inv_final_butterfly(u64& x, u64& y,
                                                    const InvFinal& f, u64 q,
                                                    u64 two_q) {
  const u64 tx = halve(x + y, two_q);
  const u64 ty = x + two_q - y;
  x = shoup(tx, f.inv_n, f.inv_n_precon, q);
  y = shoup(ty, f.inv_n_w, f.inv_n_w_precon, q);
}
