// Block-level radix-2 NTT walks over polynomials resident in shared memory.
//
// The stage order, twiddle indexing and butterflies are those of the flat
// exact-Harvey walk (hexl_tpu/ntt/jnp_ntt.py fwd_body_small/inv_body_small,
// and hexl_tpu_torch/ntt/torch_ntt.py): the forward stage with m blocks of
// stride t = n/(2m) reads rop[m + k] for block k; the inverse walks the
// stage-major irop table from index 1 upward by ascending stride. The
// threads of the block loop over the `polys * n/2` butterflies of a stage,
// with a barrier between stages. Twiddles are read from global memory
// through the read-only path, where L1/L2 keep them.
#pragma once

#include "u64.cuh"

// Forward stages of `polys` polynomials of n = 2^log_n coefficients stored
// back to back in s. Inputs [0, 4q) -> outputs [0, 4q).
__device__ __forceinline__ void block_fwd_stages(u64* s, int log_n, int polys,
                                                 const u64* __restrict__ rop,
                                                 const u64* __restrict__ prop,
                                                 u64 q) {
  const u64 two_q = 2 * q;
  const int log_half = log_n - 1;
  const int half_mask = (1 << log_half) - 1;
  const int total = polys << log_half;
  for (int log_m = 0; log_m < log_n; ++log_m) {
    const int log_t = log_half - log_m;
    const int t = 1 << log_t;
    const int m = 1 << log_m;
    for (int g = threadIdx.x; g < total; g += blockDim.x) {
      const int j = g & half_mask;
      const int k = j >> log_t;
      u64* p = s + ((g >> log_half) << log_n) + (k << (log_t + 1)) +
               (j & (t - 1));
      fwd_butterfly(p[0], p[t], __ldg(rop + m + k), __ldg(prop + m + k), q,
                    two_q);
    }
    __syncthreads();
  }
}

// Every inverse stage but the last. Inputs [0, 2q) -> outputs [0, 2q).
__device__ __forceinline__ void block_inv_stages(u64* s, int log_n, int polys,
                                                 const u64* __restrict__ irop,
                                                 const u64* __restrict__ pirop,
                                                 u64 q) {
  const u64 two_q = 2 * q;
  const int log_half = log_n - 1;
  const int half_mask = (1 << log_half) - 1;
  const int total = polys << log_half;
  int root_index = 1;
  for (int log_t = 0; log_t < log_half; ++log_t) {
    const int t = 1 << log_t;
    for (int g = threadIdx.x; g < total; g += blockDim.x) {
      const int j = g & half_mask;
      const int k = j >> log_t;
      u64* p = s + ((g >> log_half) << log_n) + (k << (log_t + 1)) +
               (j & (t - 1));
      inv_butterfly(p[0], p[t], __ldg(irop + root_index + k),
                    __ldg(pirop + root_index + k), q, two_q);
    }
    root_index += 1 << (log_half - log_t);
    __syncthreads();
  }
}

// The last inverse stage fused with N^-1, written straight to global memory
// (outputs [0, 2q), or [0, q) when omf == 1).
__device__ __forceinline__ void block_inv_final(const u64* s, u64* out,
                                                int log_n, int polys,
                                                const InvFinal& fin, u64 q,
                                                int omf) {
  const u64 two_q = 2 * q;
  const int log_half = log_n - 1;
  const int half = 1 << log_half;
  const int total = polys << log_half;
  for (int g = threadIdx.x; g < total; g += blockDim.x) {
    const int i = ((g >> log_half) << log_n) + (g & (half - 1));
    u64 x = s[i];
    u64 y = s[i + half];
    inv_final_butterfly(x, y, fin, q, two_q);
    if (omf == 1) {
      x = halve(x, q);
      y = halve(y, q);
    }
    out[i] = x;
    out[i + half] = y;
  }
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
