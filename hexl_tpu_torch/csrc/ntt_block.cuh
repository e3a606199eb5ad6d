// The NTT walks that run inside one CTA, and the kernels built on them.
//
// The stage order, twiddle indexing and butterflies are those of the flat
// exact-Harvey walk (hexl_tpu/ntt/jnp_ntt.py fwd_body_small/inv_body_small,
// and hexl_tpu_torch/ntt/torch_ntt.py): the forward stage with m blocks of
// stride t = n/(2m) reads rop[m + k] for block k; the inverse walks the
// stage-major irop table from index 1 upward by ascending stride.
//
// A CTA holds either whole transforms of n = 2^log_n (log_d = 0), or
// shard `shard` of the 2^log_d contiguous shards of one transform of
// degree 2^(log_n + log_d) (the local pass K6: of the two-pass split,
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
// Two walks. The radix walk (radix_fwd_kernel/radix_inv_kernel) runs K1
// (one 64-bit polynomial per CTA), K7 (one single-word polynomial per CTA,
// up to 2^15) and K6 (one shard per CTA, both words). The transform is
// cut into n/R groups of R = 2^LOGR coefficients (R = 8 from n = 8 on, 2
// below); a thread takes G of them (with_shape: 1024 threads from 2^13
// on, G = 2 at 2^14, 4 at 2^15; else one group a thread) and holds a
// group's R coefficients in registers while it runs up to LOGR
// consecutive stages on them, a radix pass, with no barrier and no
// shared-memory access; radix.cuh has the pass layout, the swizzle and the
// twiddle bases, which the FFT-like's K12 shares. Each stage of a pass
// reads its 2^(LOGR-1-j) twiddle pairs once. Between passes the transform
// rests in shared memory: a group is loaded in the next pass's layout and
// stored back to the same slots, so one barrier ends a pass, and the
// swizzle (radix_slot) keeps every access of every pass free of bank
// conflicts. There is no fill phase: the forward's first pass loads from
// global memory (group u reads x[u + i n/R], coalesced), the inverse's a
// row of R consecutive words; the inverse's last pass stores (coalesced,
// through the final stage fused with N^-1 and the OMF reduction for a
// whole transform, as it stands for a shard), the forward's last pass
// ends with the lean fixup and the OMF reduction, and one more barrier
// turns its groups back into the coalesced layout for the store. At 2^14
// that is 5 passes and 4 barriers (the forward 5) where the stage walk
// makes 14 shared-memory round trips and 15 barriers. Inside a stage only
// the order of the butterflies differs from the flat walk, so every
// output, lazy ones included, is bit-identical to it.
//
// What bounds it on an H100: at 2^14 u64 a transform is 128 KB, so one
// CTA fits an SM (registers and shared memory both), and 1024 threads
// leave 64 registers a thread. A 64-bit Harvey butterfly is about 50
// instructions (16 IMADs of the Shoup product, the rest 64-bit adds,
// compares and selects, per the SASS), so the walk is bound by issue, not
// by the IMAD pipe alone, with the HBM load of a wave's first pass and
// the store of its last exposed (one CTA a SM leaves nothing to overlap
// them with). R = 16 a thread (4 stages a pass) spills at 64 registers
// whatever the order of the twiddle loads; R = 8 in two groups does not,
// and runs faster. In u32 a 2^14 transform is 64 KB, and a u32 butterfly
// (one 32-bit high product, two low ones) far fewer instructions: K7 and
// the u32 K6 are bound by bytes. log_n is a constant of the instantiation
// from 2^10 up, where the pass schedule then unrolls at compile time.
//
// The stage walk (block_fwd_stages/block_inv_stages/block_inv_final):
// `polys` transforms resident in shared memory, the threads of the block
// looping over the `polys * n/2` butterflies of a stage with a barrier
// between stages, every butterfly reading its twiddle through the
// read-only path. K2 (several 64-bit polynomials per CTA) and K3
// (csrc/poly.cu) still run it.
//
// W is the word the coefficients occupy on chip: u64, or u32 for
// q < 2^30, where every lazy value is < 4q < 2^32 (the single-word regime
// of hexl_tpu/ntt/ntt32.py). Global memory always holds int64 tensors of
// u64 bits; a u32 walk narrows on the load and widens on the store. S is
// the butterfly scheme (modarith.cuh): a lean forward ends with its fixup
// before the OMF reduction, a lean inverse with its own final stage.
#pragma once

#include "modarith.cuh"
#include "radix.cuh"

// -- the stage walk (K2, K3) -------------------------------------------------

// Forward stages of `polys` transforms of n = 2^log_n coefficients stored
// back to back in s. Exact inputs [0, 4q) -> [0, 4q).
template <typename W, int S = EXACT>
__device__ __forceinline__ void block_fwd_stages(W* s, int log_n, int polys,
                                                 const u64* __restrict__ rop,
                                                 const u64* __restrict__ prop,
                                                 W q) {
  const W two_q = 2 * q;
  const int log_half = log_n - 1;
  const int half_mask = (1 << log_half) - 1;
  const int total = polys << log_half;
  for (int log_m = 0; log_m < log_n; ++log_m) {
    const int log_t = log_half - log_m;
    const int t = 1 << log_t;
    const int first = 1 << log_m;
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

// Every inverse stage but the last. Exact inputs [0, 2q) -> outputs
// [0, 2q).
template <typename W, int S = EXACT>
__device__ __forceinline__ void block_inv_stages(W* s, int log_n, int polys,
                                                 const u64* __restrict__ irop,
                                                 const u64* __restrict__ pirop,
                                                 W q) {
  const W two_q = 2 * q;
  const int log_half = log_n - 1;
  const int half_mask = (1 << log_half) - 1;
  const int total = polys << log_half;
  int root_index = 1;
  for (int log_t = 0; log_t < log_half; ++log_t) {
    const int t = 1 << log_t;
    const int first = root_index;
    for (int g = threadIdx.x; g < total; g += blockDim.x) {
      const int j = g & half_mask;
      const int k = j >> log_t;
      W* p = s + ((g >> log_half) << log_n) + (k << (log_t + 1)) +
             (j & (t - 1));
      inv_butterfly<W, S>(p[0], p[t], (W)__ldg(irop + first + k),
                          (W)__ldg(pirop + first + k), q, two_q);
    }
    // The stage of stride t has n/(2t) blocks.
    root_index += 1 << (log_half - log_t);
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

// `chunks` transforms of 2^log_n coefficients, `polys_per_cta` of them per
// CTA; the last CTA may hold fewer.
template <typename W, int S>
__global__ void __launch_bounds__(1024)
    ntt_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                   const u64* __restrict__ rop, const u64* __restrict__ prop,
                   u64 q, int log_n, int chunks, int polys_per_cta,
                   int omf) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  W* s = reinterpret_cast<W*>(ntt_smem);
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = min(polys_per_cta, (int)(chunks - first));
  const int count = polys << log_n;
  const u64* src = x + (first << log_n);
  u64* dst = y + (first << log_n);
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = (W)src[i];
  __syncthreads();
  block_fwd_stages<W, S>(s, log_n, polys, rop, prop, (W)q);
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
                   int log_n, int chunks, int polys_per_cta, int omf) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  W* s = reinterpret_cast<W*>(ntt_smem);
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = min(polys_per_cta, (int)(chunks - first));
  const int count = polys << log_n;
  const u64* src = x + (first << log_n);
  u64* dst = y + (first << log_n);
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = (W)src[i];
  __syncthreads();
  block_inv_stages<W, S>(s, log_n, polys, irop, pirop, (W)q);
  block_inv_final<W, S>(s, dst, log_n, polys, fin, (W)q, omf);
}

static int threads_for(int log_n, int polys_per_cta) {
  const long long butterflies = (long long)polys_per_cta << (log_n - 1);
  return butterflies >= 1024 ? 1024 : (int)butterflies;
}

template <typename W, int S>
static int launch_fwd(const u64* x, u64* y, const u64* rop, const u64* prop,
                      u64 q, int log_n, int chunks, int polys_per_cta,
                      int omf, cudaStream_t stream) {
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(W);
  cudaError_t err = allow_smem(ntt_fwd_kernel<W, S>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (chunks + polys_per_cta - 1) / polys_per_cta;
  ntt_fwd_kernel<W, S><<<grid, threads_for(log_n, polys_per_cta), smem,
                         stream>>>(x, y, rop, prop, q, log_n, chunks,
                                   polys_per_cta, omf);
  return (int)cudaGetLastError();
}

template <typename W, int S>
static int launch_inv(const u64* x, u64* y, const u64* irop,
                      const u64* pirop, u64 q, const InvFinal<W>& fin,
                      int log_n, int chunks, int polys_per_cta, int omf,
                      cudaStream_t stream) {
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(W);
  cudaError_t err = allow_smem(ntt_inv_kernel<W, S>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (chunks + polys_per_cta - 1) / polys_per_cta;
  ntt_inv_kernel<W, S><<<grid, threads_for(log_n, polys_per_cta), smem,
                         stream>>>(x, y, irop, pirop, q, fin, log_n, chunks,
                                   polys_per_cta, omf);
  return (int)cudaGetLastError();
}

// The stage walk's launch of scheme code `scheme` (modarith.cuh Scheme),
// in u64: K2 (every word-32 launch runs the radix walk).
static int launch_fwd_scheme(int scheme, const u64* x, u64* y,
                             const u64* rop, const u64* prop, u64 q,
                             int log_n, int chunks, int polys_per_cta,
                             int omf, cudaStream_t stream) {
  if (scheme == EXACT)
    return launch_fwd<u64, EXACT>(x, y, rop, prop, q, log_n, chunks,
                                  polys_per_cta, omf, stream);
  if (scheme == LEAN16)
    return launch_fwd<u64, LEAN16>(x, y, rop, prop, q, log_n, chunks,
                                   polys_per_cta, omf, stream);
  if (scheme == LEAN8)
    return launch_fwd<u64, LEAN8>(x, y, rop, prop, q, log_n, chunks,
                                  polys_per_cta, omf, stream);
  return (int)cudaErrorInvalidValue;
}

static int launch_inv_scheme(int scheme, const u64* x, u64* y,
                             const u64* irop, const u64* pirop, u64 q,
                             const InvFinal<u64>& fin, int log_n, int chunks,
                             int polys_per_cta, int omf,
                             cudaStream_t stream) {
  if (scheme == EXACT)
    return launch_inv<u64, EXACT>(x, y, irop, pirop, q, fin, log_n, chunks,
                                  polys_per_cta, omf, stream);
  if (scheme == LEAN16)
    return launch_inv<u64, LEAN16>(x, y, irop, pirop, q, fin, log_n, chunks,
                                   polys_per_cta, omf, stream);
  if (scheme == LEAN8)
    return launch_inv<u64, LEAN8>(x, y, irop, pirop, q, fin, log_n, chunks,
                                  polys_per_cta, omf, stream);
  return (int)cudaErrorInvalidValue;
}

// -- the radix walk (K1, K6, K7) ---------------------------------------------

// The R consecutive words row[0 .. R) in 16-byte loads where row is
// aligned (it is at every offset the wrappers give, but a tensor's storage
// offset may not be), narrowed to W: the inverse's first pass.
template <typename W, int LOGR>
__device__ __forceinline__ void radix_load_row(W (&v)[1 << LOGR],
                                               const u64* __restrict__ row) {
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const ulonglong2* r2 = reinterpret_cast<const ulonglong2*>(row);
    static_for<0, (1 << LOGR) / 2>([&](auto i) {
      const ulonglong2 p = __ldg(r2 + i);
      v[2 * i] = (W)p.x;
      v[2 * i + 1] = (W)p.y;
    });
  } else {
    static_for<0, (1 << LOGR)>([&](auto i) { v[i] = (W)__ldg(row + i); });
  }
}

// The stages of one pass. In the pass with register bits at s, the
// stage of register bit j (stride 2^(s + j)) gives each thread
// C = 2^(LOGR-1-j) butterfly blocks, consecutive from tb C (tb = t >> s),
// each of 2^j butterflies (i, i + 2^j). Its twiddles start at g >> j, g
// formed once a pass (radix_fwd_g, radix_inv_g): every term of the flat
// index is a multiple of 2^j there, so one shift gives it.

// Forward, j = top - 1 down to 0: block k of the stage with m blocks per
// shard at rop[m (2^log_d + shard) + k].
template <typename W, int S, int LOGR>
__device__ __forceinline__ void radix_fwd_pass(
    W (&v)[1 << LOGR], int top, int g, const u64* __restrict__ rop,
    const u64* __restrict__ prop, W q, W two_q) {
  static_for<0, LOGR>([&](auto jj) {
    constexpr int J = LOGR - 1 - decltype(jj)::value;
    if (J < top) {
      const int at = g >> J;
      static_for<0, (1 << (LOGR - 1 - J))>([&](auto c) {
        const W w = (W)__ldg(rop + at + c), wp = (W)__ldg(prop + at + c);
        static_for<0, (1 << J)>([&](auto k) {
          constexpr int I = (decltype(c)::value << (J + 1)) + decltype(k)::value;
          fwd_butterfly<W, S>(v[I], v[I + (1 << J)], w, wp, q, two_q);
        });
      });
    }
  });
}

// Inverse, j in [lo, hi) ascending: block k at stride 2^b (b = s + j) at
// irop[1 + N - N/2^b + shard n/2^(b+1) + k] (N = n 2^log_d); irop1 and
// pirop1 point at the tables' entry 1 + N, g (negative) is the rest.
template <typename W, int S, int LOGR>
__device__ __forceinline__ void radix_inv_pass(
    W (&v)[1 << LOGR], int lo, int hi, int g, const u64* __restrict__ irop1,
    const u64* __restrict__ pirop1, W q, W two_q) {
  static_for<0, LOGR>([&](auto jj) {
    constexpr int J = decltype(jj)::value;
    if (J >= lo && J < hi) {
      const int at = g >> J;
      static_for<0, (1 << (LOGR - 1 - J))>([&](auto c) {
        const W w = (W)__ldg(irop1 + at + c), wp = (W)__ldg(pirop1 + at + c);
        static_for<0, (1 << J)>([&](auto k) {
          constexpr int I = (decltype(c)::value << (J + 1)) + decltype(k)::value;
          inv_butterfly<W, S>(v[I], v[I + (1 << J)], w, wp, q, two_q);
        });
      });
    }
  });
}

// One transform or shard of n = 2^log_n per CTA. Its n/R coefficient
// groups of R = 2^LOGR (the virtual threads u of the pass layout) go to T
// threads, G groups each (u = t + h T, h < G), one group after the
// other, so that a thread holds R coefficients in registers at a time.
// Shared memory holds the transform between passes: a group is loaded
// from it in the pass's layout and stored back to the same slots, so one
// barrier ends each pass. LOGN, when not 0, is log_n as a constant of the
// instantiation (the pass schedule then unrolls at compile time).
//
// Forward passes from the top stride down: pass p runs the stages of
// strides 2^s .. 2^(hi - 1), hi = log_n - p LOGR, s = max(hi - LOGR, 0).
// The first loads from global memory (u reads x[u + i n/R]), the last
// ends with the lean fixup and the OMF reduction; after one more barrier
// each group is read back in the first pass's layout and stored,
// coalesced.
template <typename W, int S, int LOGR, int G, int LOGN>
__global__ void __launch_bounds__(1024)
    radix_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ rop,
                     const u64* __restrict__ prop, u64 q64, int log_n_arg,
                     int omf, int log_d, int shard_base, int log_sub) {
  constexpr int R = 1 << LOGR;
  const int log_n = LOGN ? LOGN : log_n_arg;
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  W* sm = reinterpret_cast<W*>(ntt_smem);
  const W q = (W)q64;
  const W two_q = 2 * q;
  const int t = threadIdx.x;
  const int shard = shard_base + (blockIdx.x & ((1 << log_sub) - 1));
  const int first_block = (1 << log_d) + shard;
  const long long off = (long long)blockIdx.x << log_n;
  const int passes = (log_n + LOGR - 1) / LOGR;
#pragma unroll
  for (int p = 0; p < passes; ++p) {
    const int hi = log_n - p * LOGR, s = max(hi - LOGR, 0);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int u = t + h * blockDim.x;
      W v[R];
      if (p == 0) {
        static_for<0, R>([&](auto i) {
          v[i] = (W)__ldg(x + off + u + (decltype(i)::value << s));
        });
      } else {
        radix_get<W, LOGR>(sm, v, u, s);
      }
      radix_fwd_pass<W, S, LOGR>(v, hi - s,
                                 radix_fwd_g(first_block, log_n, s, u, LOGR),
                                 rop, prop, q, two_q);
      if (p == passes - 1) {
        static_for<0, R>([&](auto i) {
          const W r = fwd_fixup<W, S>(v[i], q);
          v[i] = omf == 1 ? reduce_lazy<W>(r, q, 4) : r;
        });
      }
      radix_put<W, LOGR>(sm, v, u, s);
    }
    __syncthreads();
  }
#pragma unroll 1
  for (int h = 0; h < G; ++h) {
    const int u = t + h * blockDim.x;
    W v[R];
    radix_get<W, LOGR>(sm, v, u, log_n - LOGR);
    static_for<0, R>([&](auto i) {
      y[off + u + (decltype(i)::value << (log_n - LOGR))] = v[i];
    });
  }
}

// Inverse passes from the bottom stride up: pass p runs the stages of
// strides 2^lo .. 2^(hi - 1), lo = p LOGR, hi = min(lo + LOGR, log_n),
// on register bits at s = min(lo, log_n - LOGR). The first loads a row of
// R consecutive words from global memory, the last stores coalesced (u
// writes y[u + i n/R]). FINAL (a whole transform, log_d = 0): the last
// pass's top stage is the final stage fused with N^-1 and the OMF
// reduction; a shard has none.
template <typename W, int S, int LOGR, int G, int LOGN, bool FINAL>
__global__ void __launch_bounds__(1024)
    radix_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ irop1,
                     const u64* __restrict__ pirop1, u64 q64,
                     InvFinal<W> fin, int log_n_arg, int omf, int log_d,
                     int shard_base, int log_sub) {
  constexpr int R = 1 << LOGR;
  const int log_n = LOGN ? LOGN : log_n_arg;
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  W* sm = reinterpret_cast<W*>(ntt_smem);
  const W q = (W)q64;
  const W two_q = 2 * q;
  const int t = threadIdx.x;
  const int shard = shard_base + (blockIdx.x & ((1 << log_sub) - 1));
  const long long off = (long long)blockIdx.x << log_n;
  const int passes = (log_n + LOGR - 1) / LOGR;
#pragma unroll
  for (int p = 0; p < passes; ++p) {
    const int lo = p * LOGR, hi = min(lo + LOGR, log_n);
    const int s = min(lo, log_n - LOGR);
    const bool last = p == passes - 1;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int u = t + h * blockDim.x;
      W v[R];
      if (p == 0) {
        radix_load_row<W, LOGR>(v, x + off + ((long long)u << LOGR));
      } else {
        radix_get<W, LOGR>(sm, v, u, s);
      }
      radix_inv_pass<W, S, LOGR>(
          v, lo - s, hi - s - (FINAL && last),
          radix_inv_g(shard, log_n, log_n + log_d, s, u, LOGR), irop1,
          pirop1, q, two_q);
      if (!last) {
        radix_put<W, LOGR>(sm, v, u, s);
        continue;
      }
      if constexpr (FINAL) {
        static_for<0, R / 2>([&](auto i) {
          inv_final_butterfly<W, S>(v[i], v[i + R / 2], fin, q, two_q);
          if (omf == 1) {
            v[i] = halve(v[i], q);
            v[i + R / 2] = halve(v[i + R / 2], q);
          }
        });
      }
      static_for<0, R>([&](auto i) {
        y[off + u + (decltype(i)::value << s)] = v[i];
      });
    }
    if (!last) __syncthreads();
  }
}

// The shape of the radix walk follows the word, log_n and the grid: R = 8
// from n = 8 on, one group a thread up to 2^13 (n/8 threads), two at 2^14
// and four at 2^15 (u32 only: 128 KB), 1024 threads; R = 2 below n = 8.
// In u32, 2^13 and 2^14 also have a form of 512 threads (G = 2 and 4) that
// fits two CTAs a SM (registers and shared memory both), so that one
// CTA's first load overlaps the other's passes: `two_per_sm` takes it
// where the launch has more CTAs than the card has SMs; a launch of one
// wave or less keeps 1024 threads a CTA (PERF.md's findings). From
// 2^10 up, the sizes of K1's, K6's and K7's main paths, log_n is a
// constant of the instantiation.
// f(Index<LOGR>{}, Index<G>{}, Index<LOGN>{}).
template <typename W, typename F>
static int with_shape(int log_n, bool two_per_sm, F&& f) {
  constexpr bool U32 = sizeof(W) == 4;
  switch (log_n) {
    case 15:
      if constexpr (U32) return f(Index<3>{}, Index<4>{}, Index<15>{});
      return (int)cudaErrorInvalidValue;
    case 14:
      if constexpr (U32)
        if (two_per_sm) return f(Index<3>{}, Index<4>{}, Index<14>{});
      return f(Index<3>{}, Index<2>{}, Index<14>{});
    case 13:
      if constexpr (U32)
        if (two_per_sm) return f(Index<3>{}, Index<2>{}, Index<13>{});
      return f(Index<3>{}, Index<1>{}, Index<13>{});
    case 12:
      return f(Index<3>{}, Index<1>{}, Index<12>{});
    case 11:
      return f(Index<3>{}, Index<1>{}, Index<11>{});
    case 10:
      return f(Index<3>{}, Index<1>{}, Index<10>{});
    default:
      if (log_n >= 3) return f(Index<3>{}, Index<1>{}, Index<0>{});
      return f(Index<1>{}, Index<1>{}, Index<0>{});
  }
}

// The SMs of the current device (0 if the runtime cannot say).
static int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <typename W, int S>
static int launch_radix_fwd(const u64* x, u64* y, const u64* rop,
                            const u64* prop, u64 q, int log_n, int chunks,
                            int omf, int log_d, int shard_base, int log_sub,
                            cudaStream_t stream) {
  const bool two_per_sm = chunks > sm_count();
  return with_shape<W>(log_n, two_per_sm, [&](auto logr, auto g, auto logn) {
    constexpr int LOGR = decltype(logr)::value, G = decltype(g)::value;
    constexpr int LOGN = decltype(logn)::value;
    const size_t smem = ((size_t)1 << log_n) * sizeof(W);
    const int err =
        (int)allow_smem(radix_fwd_kernel<W, S, LOGR, G, LOGN>, smem);
    if (err != 0) return err;
    radix_fwd_kernel<W, S, LOGR, G, LOGN><<<chunks, (1 << log_n) / (G << LOGR),
                                            smem, stream>>>(
        x, y, rop, prop, q, log_n, omf, log_d, shard_base, log_sub);
    return (int)cudaGetLastError();
  });
}

template <typename W, int S, bool FINAL>
static int launch_radix_inv(const u64* x, u64* y, const u64* irop,
                            const u64* pirop, u64 q, const InvFinal<W>& fin,
                            int log_n, int chunks, int omf, int log_d,
                            int shard_base, int log_sub,
                            cudaStream_t stream) {
  const bool two_per_sm = chunks > sm_count();
  return with_shape<W>(log_n, two_per_sm, [&](auto logr, auto g, auto logn) {
    constexpr int LOGR = decltype(logr)::value, G = decltype(g)::value;
    constexpr int LOGN = decltype(logn)::value;
    const size_t smem = ((size_t)1 << log_n) * sizeof(W);
    const int err =
        (int)allow_smem(radix_inv_kernel<W, S, LOGR, G, LOGN, FINAL>, smem);
    if (err != 0) return err;
    // The kernel takes the tables from entry 1 + N on (radix_inv_pass).
    const size_t skip = 1 + ((size_t)1 << (log_n + log_d));
    radix_inv_kernel<W, S, LOGR, G, LOGN, FINAL><<<
        chunks, (1 << log_n) / (G << LOGR), smem, stream>>>(
        x, y, irop + skip, pirop + skip, q, fin, log_n, omf, log_d,
        shard_base, log_sub);
    return (int)cudaGetLastError();
  });
}

// The radix walk of scheme code `scheme`: exact in either word, the lean
// schemes in u64 only.
template <typename W>
static int launch_radix_fwd_scheme(int scheme, const u64* x, u64* y,
                                   const u64* rop, const u64* prop, u64 q,
                                   int log_n, int chunks, int omf, int log_d,
                                   int shard_base, int log_sub,
                                   cudaStream_t stream) {
  if (scheme == EXACT)
    return launch_radix_fwd<W, EXACT>(x, y, rop, prop, q, log_n, chunks, omf,
                                      log_d, shard_base, log_sub, stream);
  if constexpr (sizeof(W) == 8) {
    if (scheme == LEAN16)
      return launch_radix_fwd<W, LEAN16>(x, y, rop, prop, q, log_n, chunks,
                                         omf, log_d, shard_base, log_sub,
                                         stream);
    if (scheme == LEAN8)
      return launch_radix_fwd<W, LEAN8>(x, y, rop, prop, q, log_n, chunks,
                                        omf, log_d, shard_base, log_sub,
                                        stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename W, bool FINAL>
static int launch_radix_inv_scheme(int scheme, const u64* x, u64* y,
                                   const u64* irop, const u64* pirop, u64 q,
                                   const InvFinal<W>& fin, int log_n,
                                   int chunks, int omf, int log_d,
                                   int shard_base, int log_sub,
                                   cudaStream_t stream) {
  if (scheme == EXACT)
    return launch_radix_inv<W, EXACT, FINAL>(x, y, irop, pirop, q, fin, log_n,
                                             chunks, omf, log_d, shard_base,
                                             log_sub, stream);
  if constexpr (sizeof(W) == 8) {
    if (scheme == LEAN16)
      return launch_radix_inv<W, LEAN16, FINAL>(x, y, irop, pirop, q, fin,
                                                log_n, chunks, omf, log_d,
                                                shard_base, log_sub, stream);
    if (scheme == LEAN8)
      return launch_radix_inv<W, LEAN8, FINAL>(x, y, irop, pirop, q, fin,
                                               log_n, chunks, omf, log_d,
                                               shard_base, log_sub, stream);
  }
  return (int)cudaErrorInvalidValue;
}
