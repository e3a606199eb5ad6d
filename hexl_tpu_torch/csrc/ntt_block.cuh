// Block-level radix-2 NTT walks over transforms resident in shared memory,
// and the two kernels built on them (one direction each).
//
// The stage order, twiddle indexing and butterflies are those of the flat
// exact-Harvey walk (hexl_tpu/ntt/jnp_ntt.py fwd_body_small/inv_body_small,
// and hexl_tpu_torch/ntt/torch_ntt.py): the forward stage with m blocks of
// stride t = n/(2m) reads rop[m + k] for block k; the inverse walks the
// stage-major irop table from index 1 upward by ascending stride. The
// threads of the block loop over the `polys * n/2` butterflies of a stage,
// with a barrier between stages. Twiddles are read from global memory
// through the read-only path, where L1/L2 keep them.
//
// A CTA holds either whole transforms of n = 2^log_n (log_d = 0: K1, K2,
// K7), or shard `shard` of the 2^log_d contiguous shards of one transform
// of degree 2^(log_n + log_d) (the local pass K6: of the two-pass split,
// hexl_tpu_torch/ntt/hier.py, and of one position of the coefficient-
// sharded transform, hexl_tpu_torch/parallel/dist_ntt.py). A shard runs
// the global stages of stride t < n in place, with its twiddles read from
// the flat tables at its offset: forward block k of the stage with m
// blocks per shard reads rop[m * (2^log_d + shard) + k]; inverse block k
// at stride t reads irop[root_index(t) + shard * n/(2t) + k]. With
// log_d = 0 these are the flat walk's indices. The inverse of a shard
// stops before the global final stage, which the cross pass K5 runs.
// The CTAs of a launch hold consecutive chunks of x; the shard of CTA b
// is shard_base + (b mod 2^log_sub): the two-pass split passes
// (0, log_d), every shard of each polynomial in turn; a position of the
// sharded transform passes its own shard (log_sub = 0), or its first
// 2^14-coefficient sub-shard and their count when it holds more.
//
// W is the word the coefficients occupy in shared memory: u64, or u32 for
// q < 2^30, where every lazy value is < 4q < 2^32 (the single-word regime
// of hexl_tpu/ntt/ntt32.py). Global memory always holds int64 tensors of
// u64 bits; a u32 walk narrows on the load and widens on the store. S is
// the butterfly scheme (modarith.cuh): a lean forward ends with its fixup
// before the OMF reduction, a lean inverse with its own final stage.
#pragma once

#include "modarith.cuh"

// Forward stages of `polys` transforms (or shards) of n = 2^log_n
// coefficients stored back to back in s. Exact inputs [0, 4q) -> [0, 4q).
template <typename W, int S = EXACT>
__device__ __forceinline__ void block_fwd_stages(W* s, int log_n, int polys,
                                                 const u64* __restrict__ rop,
                                                 const u64* __restrict__ prop,
                                                 W q, int log_d, int shard) {
  const W two_q = 2 * q;
  const int log_half = log_n - 1;
  const int half_mask = (1 << log_half) - 1;
  const int total = polys << log_half;
  const int base = (1 << log_d) + shard;
  for (int log_m = 0; log_m < log_n; ++log_m) {
    const int log_t = log_half - log_m;
    const int t = 1 << log_t;
    const int first = base << log_m;
    for (int g = threadIdx.x; g < total; g += blockDim.x) {
      const int j = g & half_mask;
      const int k = j >> log_t;
      W* p = s + ((g >> log_half) << log_n) + (k << (log_t + 1)) +
             (j & (t - 1));
      fwd_butterfly<W, S>(p[0], p[t], (W)__ldg(rop + first + k),
                          (W)__ldg(prop + first + k), q, two_q);
    }
    __syncthreads();
  }
}

// The inverse stages of stride t < n, except the global final stage:
// every stage of a shard (log_d > 0), every stage but the last of a whole
// transform (log_d = 0). Exact inputs [0, 2q) -> outputs [0, 2q).
template <typename W, int S = EXACT>
__device__ __forceinline__ void block_inv_stages(W* s, int log_n, int polys,
                                                 const u64* __restrict__ irop,
                                                 const u64* __restrict__ pirop,
                                                 W q, int log_d, int shard) {
  const W two_q = 2 * q;
  const int log_half = log_n - 1;
  const int half_mask = (1 << log_half) - 1;
  const int total = polys << log_half;
  const int stages = log_d > 0 ? log_n : log_half;
  int root_index = 1;
  for (int log_t = 0; log_t < stages; ++log_t) {
    const int t = 1 << log_t;
    const int first = root_index + (shard << (log_half - log_t));
    for (int g = threadIdx.x; g < total; g += blockDim.x) {
      const int j = g & half_mask;
      const int k = j >> log_t;
      W* p = s + ((g >> log_half) << log_n) + (k << (log_t + 1)) +
             (j & (t - 1));
      inv_butterfly<W, S>(p[0], p[t], (W)__ldg(irop + first + k),
                          (W)__ldg(pirop + first + k), q, two_q);
    }
    // The global stage of stride t has N/(2t) blocks, N = n * 2^log_d.
    root_index += 1 << (log_half + log_d - log_t);
    __syncthreads();
  }
}

// The last inverse stage fused with N^-1, written straight to global memory
// (outputs [0, 2q), or [0, q) when omf == 1).
template <typename W, int S = EXACT>
__device__ __forceinline__ void block_inv_final(const W* s, u64* out,
                                                int log_n, int polys,
                                                const InvFinal<W>& fin, W q,
                                                int omf) {
  const W two_q = 2 * q;
  const int log_half = log_n - 1;
  const int half = 1 << log_half;
  const int total = polys << log_half;
  for (int g = threadIdx.x; g < total; g += blockDim.x) {
    const int i = ((g >> log_half) << log_n) + (g & (half - 1));
    W x = s[i];
    W y = s[i + half];
    inv_final_butterfly<W, S>(x, y, fin, q, two_q);
    if (omf == 1) {
      x = halve(x, q);
      y = halve(y, q);
    }
    out[i] = x;
    out[i + half] = y;
  }
}

// `chunks` transforms (or shards) of 2^log_n coefficients, `polys_per_cta`
// of them per CTA (1 for shards); the last CTA may hold fewer.
template <typename W, int S>
__global__ void __launch_bounds__(1024)
    ntt_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                   const u64* __restrict__ rop, const u64* __restrict__ prop,
                   u64 q, int log_n, int chunks, int polys_per_cta, int omf,
                   int log_d, int shard_base, int log_sub) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  W* s = reinterpret_cast<W*>(ntt_smem);
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = min(polys_per_cta, (int)(chunks - first));
  const int count = polys << log_n;
  const int shard = shard_base + (blockIdx.x & ((1 << log_sub) - 1));
  const u64* src = x + (first << log_n);
  u64* dst = y + (first << log_n);
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = (W)src[i];
  __syncthreads();
  block_fwd_stages<W, S>(s, log_n, polys, rop, prop, (W)q, log_d, shard);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const W v = fwd_fixup<W, S>(s[i], (W)q);
    dst[i] = omf == 1 ? reduce_lazy<W>(v, (W)q, 4) : v;
  }
}

template <typename W, int S>
__global__ void __launch_bounds__(1024)
    ntt_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                   const u64* __restrict__ irop,
                   const u64* __restrict__ pirop, u64 q, InvFinal<W> fin,
                   int log_n, int chunks, int polys_per_cta, int omf,
                   int log_d, int shard_base, int log_sub) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  W* s = reinterpret_cast<W*>(ntt_smem);
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = min(polys_per_cta, (int)(chunks - first));
  const int count = polys << log_n;
  const int shard = shard_base + (blockIdx.x & ((1 << log_sub) - 1));
  const u64* src = x + (first << log_n);
  u64* dst = y + (first << log_n);
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = (W)src[i];
  __syncthreads();
  block_inv_stages<W, S>(s, log_n, polys, irop, pirop, (W)q, log_d, shard);
  if (log_d == 0) {
    block_inv_final<W, S>(s, dst, log_n, polys, fin, (W)q, omf);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = s[i];
  }
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

static int threads_for(int log_n, int polys_per_cta) {
  const long long butterflies = (long long)polys_per_cta << (log_n - 1);
  return butterflies >= 1024 ? 1024 : (int)butterflies;
}

template <typename W, int S>
static int launch_fwd(const u64* x, u64* y, const u64* rop, const u64* prop,
                      u64 q, int log_n, int chunks, int polys_per_cta,
                      int omf, int log_d, int shard_base, int log_sub,
                      cudaStream_t stream) {
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(W);
  cudaError_t err = allow_smem(ntt_fwd_kernel<W, S>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (chunks + polys_per_cta - 1) / polys_per_cta;
  ntt_fwd_kernel<W, S><<<grid, threads_for(log_n, polys_per_cta), smem,
                         stream>>>(x, y, rop, prop, q, log_n, chunks,
                                   polys_per_cta, omf, log_d, shard_base,
                                   log_sub);
  return (int)cudaGetLastError();
}

template <typename W, int S>
static int launch_inv(const u64* x, u64* y, const u64* irop,
                      const u64* pirop, u64 q, const InvFinal<W>& fin,
                      int log_n, int chunks, int polys_per_cta, int omf,
                      int log_d, int shard_base, int log_sub,
                      cudaStream_t stream) {
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(W);
  cudaError_t err = allow_smem(ntt_inv_kernel<W, S>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (chunks + polys_per_cta - 1) / polys_per_cta;
  ntt_inv_kernel<W, S><<<grid, threads_for(log_n, polys_per_cta), smem,
                         stream>>>(x, y, irop, pirop, q, fin, log_n, chunks,
                                   polys_per_cta, omf, log_d, shard_base,
                                   log_sub);
  return (int)cudaGetLastError();
}

// The launch of scheme code `scheme` (modarith.cuh Scheme): the exact
// instantiation for either word, the lean ones for u64 only.
template <typename W>
static int launch_fwd_scheme(int scheme, const u64* x, u64* y,
                             const u64* rop, const u64* prop, u64 q,
                             int log_n, int chunks, int polys_per_cta,
                             int omf, int log_d, int shard_base, int log_sub,
                             cudaStream_t stream) {
  if (scheme == EXACT)
    return launch_fwd<W, EXACT>(x, y, rop, prop, q, log_n, chunks,
                                polys_per_cta, omf, log_d, shard_base,
                                log_sub, stream);
  if constexpr (sizeof(W) == 8) {
    if (scheme == LEAN16)
      return launch_fwd<W, LEAN16>(x, y, rop, prop, q, log_n, chunks,
                                   polys_per_cta, omf, log_d, shard_base,
                                   log_sub, stream);
    if (scheme == LEAN8)
      return launch_fwd<W, LEAN8>(x, y, rop, prop, q, log_n, chunks,
                                  polys_per_cta, omf, log_d, shard_base,
                                  log_sub, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename W>
static int launch_inv_scheme(int scheme, const u64* x, u64* y,
                             const u64* irop, const u64* pirop, u64 q,
                             const InvFinal<W>& fin, int log_n, int chunks,
                             int polys_per_cta, int omf, int log_d,
                             int shard_base, int log_sub,
                             cudaStream_t stream) {
  if (scheme == EXACT)
    return launch_inv<W, EXACT>(x, y, irop, pirop, q, fin, log_n, chunks,
                                polys_per_cta, omf, log_d, shard_base,
                                log_sub, stream);
  if constexpr (sizeof(W) == 8) {
    if (scheme == LEAN16)
      return launch_inv<W, LEAN16>(x, y, irop, pirop, q, fin, log_n, chunks,
                                   polys_per_cta, omf, log_d, shard_base,
                                   log_sub, stream);
    if (scheme == LEAN8)
      return launch_inv<W, LEAN8>(x, y, irop, pirop, q, fin, log_n, chunks,
                                  polys_per_cta, omf, log_d, shard_base,
                                  log_sub, stream);
  }
  return (int)cudaErrorInvalidValue;
}
