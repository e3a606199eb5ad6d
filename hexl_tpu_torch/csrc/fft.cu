// K12 and K13: the FFT-like transform of CKKS encode/decode over the complex
// 2N-th roots (hexl_tpu/experimental/fft_like.py FFTLike), in three
// arithmetics: complex double ("f64"), complex float ("single") and complex
// double-float on four float32 planes ("double_float", df32.py).
//
// K12 replaces hexl_tpu/experimental/pallas_fft.py::_run: a CTA holds
// transforms of n = 2^log_n <= 2^13 coefficients in shared memory and
// walks every stage between one load and one store of each coefficient.
// The forward runs to bit-reversed output with the scalar fused into the
// stride-1 stage; the inverse runs from bit-reversed input with the scalar
// fused into its final stage, which uses the full complex product (cdf_mul
// in double-float) where every other stage uses the presplit one
// (cdf_mul_ps). The stage order, twiddle indices and products are those of
// the flat walks (_stage_loop_fwd/_inv and their _df forms); only the
// order of the butterflies within a stage differs, so every output is
// bit-equal to the plain version in hexl_tpu_torch/experimental.
//
// Two walks. One transform (or one block of a split transform) per CTA
// runs the radix walk of radix.cuh, the walk of the NTT's K1, K6 and K7
// in complex arithmetic: groups of R = 8 values (2 below n = 8) held in
// registers through up to three stages a pass, each stage's twiddle read
// once per group and block (and split once, in double-float, for every
// product of its block), the transform resting in shared memory between
// passes (one barrier a pass; the radix_slot swizzle keeps the 8- and
// 16-byte accesses free of bank conflicts, so re and im stay interleaved).
// The forward's first pass loads coalesced from global memory, and one
// more exchange turns its last pass's groups into the coalesced layout for
// the store; the inverse loads rows of R consecutive values and its last
// pass stores coalesced. At 2^13 that is 5 passes where the stage walk
// makes 13 round trips through shared memory. Several small transforms
// per CTA (n <= 2^12 with a batch that leaves CTAs to spare, the rule of
// ntt/cuda_ntt.py::polys_per_cta) run the stage walk: the block's threads
// loop over every butterfly of a stage, a barrier between stages, each
// butterfly reading its own twiddle.
//
// Limit taken: 2^13 coefficients per CTA in every arithmetic, 16 bytes
// each for f64 and double-float (128 KB of the 227 KB a CTA may opt into);
// single precision (8 bytes) stops at 2^13 too, so that all three share one
// split. Above 2^13, K13 (the cross pass) runs the stages of stride >= 2^13:
// a thread holds the D = n / 2^13 coefficients at one offset in registers
// (D <= 16, so n <= 2^17), as K5 does for the NTT; the inverse's final
// stage, scalar and all, runs there. K12 then runs the other stages on each
// 2^13 block (the radix walk), reading the tables at the block's offset,
// as K6 does.
//
// No arithmetic here is contracted: every add, subtract and multiply is a
// round-to-nearest intrinsic (__dadd_rn, __fmul_rn, ...), which nvcc never
// fuses into an FMA. A contracted Dekker product is no longer error free
// (the JAX package measured its DF forward degrading from 8e-15 to 6e-8),
// and with the intrinsics all three arithmetics are bit-exact against
// their plain PyTorch versions, which are separate torch ops.
//
// What bounds them on an H100: each pass reads and writes every coefficient
// once (32 bytes per coefficient in f64 and double-float, 16 in single),
// against 10 floating-point operations per butterfly in f64 and single and
// 126 in double-float (the presplit Dekker product and two complex adds),
// plus the 8 of splitting each twiddle once. A transform of 2^13 f64 or
// single coefficients over its 13 stages is bound by bytes; the
// double-float one by its float32 operations. 2^13 f64 or double-float
// values fill 128 KB, so one CTA a SM: its first load and last store are
// exposed, as K1's are.
#include <type_traits>

#include "fft_arith.cuh"
#include "radix.cuh"

constexpr int FFT_LOG_BLOCK = 13;
constexpr int CROSS_THREADS = 128;

// ---- K12: the radix walk (one transform or block per CTA) -------------------

// A CTA holds a whole transform (log_d = 0) or block `shard` of the
// 2^log_d contiguous blocks of one transform of degree N = n * 2^log_d,
// whose stages of stride < n it runs with the tables read at its offset
// (radix.cuh: forward block k of the stage with m blocks per shard reads
// table[m * (2^log_d + shard) + k]; inverse block k at stride t reads
// table[N + 1 - N/t + shard * n/(2t) + k]).

// The forward stages of one pass, j = top - 1 down to 0. `scaled`: the
// pass holds the stride-1 stage (j = 0 at s = 0), whose twiddles and
// upper inputs are scaled by sc first.
template <class P, int LOGR>
__device__ __forceinline__ void fft_radix_fwd_pass(
    typename P::V (&v)[1 << LOGR], int top, int g, const Ptrs& tab,
    const typename P::S& sc, bool scaled) {
  using V = typename P::V;
  static_for<0, LOGR>([&](auto jj) {
    constexpr int J = LOGR - 1 - decltype(jj)::value;
    if (J < top) {
      const int at = g >> J;
      static_for<0, (1 << (LOGR - 1 - J))>([&](auto c) {
        V w = P::load(tab, at + decltype(c)::value);
        if (J == 0 && scaled) w = P::scale(w, sc);
        const typename P::Tw tw = P::twiddle(w);
        static_for<0, (1 << J)>([&](auto k) {
          constexpr int I =
              (decltype(c)::value << (J + 1)) + decltype(k)::value;
          V xs = v[I];
          if (J == 0 && scaled) xs = P::scale(xs, sc);
          const V tt = P::mul_tw(v[I + (1 << J)], tw);
          v[I] = P::add(xs, tt);
          v[I + (1 << J)] = P::sub(xs, tt);
        });
      });
    }
  });
}

// The inverse stages of one pass, j in [lo, hi) ascending; g is relative
// to table entry tab_off = 1 + N.
template <class P, int LOGR>
__device__ __forceinline__ void fft_radix_inv_pass(
    typename P::V (&v)[1 << LOGR], int lo, int hi, int g, const Ptrs& tab,
    int tab_off) {
  using V = typename P::V;
  static_for<0, LOGR>([&](auto jj) {
    constexpr int J = decltype(jj)::value;
    if (J >= lo && J < hi) {
      const int at = tab_off + (g >> J);
      static_for<0, (1 << (LOGR - 1 - J))>([&](auto c) {
        const typename P::Tw tw =
            P::twiddle(P::load(tab, at + decltype(c)::value));
        static_for<0, (1 << J)>([&](auto k) {
          constexpr int I =
              (decltype(c)::value << (J + 1)) + decltype(k)::value;
          const V a = v[I];
          const V b = v[I + (1 << J)];
          v[I] = P::add(a, b);
          v[I + (1 << J)] = P::mul_tw(P::sub(a, b), tw);
        });
      });
    }
  });
}

// The threads of a radix instantiation: its own count where log_n is
// fixed (so that ptxas may give a smaller CTA more registers), else the
// policy's most.
template <class P, int LOGR, int G, int LOGN>
__host__ __device__ constexpr int fft_radix_threads() {
  return LOGN ? (1 << LOGN) / (G << LOGR) : P::THREADS;
}

// f(p) for the passes p = 0 .. passes - 1, unrolled where LOGN fixes
// their count.
template <int LOGN, typename F>
__device__ __forceinline__ void fft_passes(int passes, F&& f) {
  if constexpr (LOGN != 0) {
#pragma unroll
    for (int p = 0; p < passes; ++p) f(p);
  } else {
#pragma unroll 1
    for (int p = 0; p < passes; ++p) f(p);
  }
}

// Forward passes from the top stride down, as the NTT's radix_fwd_kernel:
// pass p runs the stages of strides 2^s .. 2^(hi - 1), hi = log_n - p LOGR,
// s = max(hi - LOGR, 0). The first loads from global memory (group u reads
// x[u + i n/R]); after the last, one more barrier and each group is read
// back in the first pass's layout and stored, coalesced. LOGN, when not 0,
// is log_n as a constant of the instantiation.
template <class P, int LOGR, int G, int LOGN>
__global__ void __launch_bounds__(fft_radix_threads<P, LOGR, G, LOGN>())
    fft_radix_fwd_kernel(Ptrs x, Ptrs y, Ptrs tab, typename P::S sc,
                         int has_scalar, int log_n_arg, int log_d) {
  using V = typename P::V;
  constexpr int R = 1 << LOGR;
  const int log_n = LOGN ? LOGN : log_n_arg;
  extern __shared__ __align__(16) unsigned char fft_smem[];
  V* sm = reinterpret_cast<V*>(fft_smem);
  const int t = threadIdx.x;
  const int first_block = (1 << log_d) + (blockIdx.x & ((1 << log_d) - 1));
  const long long off = (long long)blockIdx.x << log_n;
  fft_passes<LOGN>((log_n + LOGR - 1) / LOGR, [&](int p) {
    const int hi = log_n - p * LOGR, s = max(hi - LOGR, 0);
#pragma unroll 1
    for (int h = 0; h < G; ++h) {
      const int u = t + h * blockDim.x;
      V v[R];
      if (p == 0) {
        static_for<0, R>([&](auto i) {
          v[i] = P::load(x, off + u + (decltype(i)::value << s));
        });
      } else {
        radix_get<V, LOGR>(sm, v, u, s);
      }
      fft_radix_fwd_pass<P, LOGR>(
          v, hi - s, radix_fwd_g(first_block, log_n, s, u, LOGR), tab, sc,
          has_scalar && s == 0);
      radix_put<V, LOGR>(sm, v, u, s);
    }
    __syncthreads();
  });
#pragma unroll 1
  for (int h = 0; h < G; ++h) {
    const int u = t + h * blockDim.x;
    V v[R];
    radix_get<V, LOGR>(sm, v, u, log_n - LOGR);
    static_for<0, R>([&](auto i) {
      P::store(y, off + u + (decltype(i)::value << (log_n - LOGR)), v[i]);
    });
  }
}

// Inverse passes from the bottom stride up: pass p runs the stages of
// strides 2^lo .. 2^(hi - 1), lo = p LOGR, hi = min(lo + LOGR, log_n), on
// register bits at s = min(lo, log_n - LOGR). The first loads a row of R
// consecutive values, the last stores coalesced (u writes y[u + i n/R]).
// A whole transform with a scalar (log_d = 0) ends with the final stage
// fused with it: the last pass's top stage, (a + b) sc and
// (a - b) (table[n - 1] sc) by the full product.
template <class P, int LOGR, int G, int LOGN>
__global__ void __launch_bounds__(fft_radix_threads<P, LOGR, G, LOGN>())
    fft_radix_inv_kernel(Ptrs x, Ptrs y, Ptrs tab, typename P::S sc,
                         int has_scalar, int log_n_arg, int log_d) {
  using V = typename P::V;
  constexpr int R = 1 << LOGR;
  const int log_n = LOGN ? LOGN : log_n_arg;
  extern __shared__ __align__(16) unsigned char fft_smem[];
  V* sm = reinterpret_cast<V*>(fft_smem);
  const int t = threadIdx.x;
  const int shard = blockIdx.x & ((1 << log_d) - 1);
  const long long off = (long long)blockIdx.x << log_n;
  const bool fused = log_d == 0 && has_scalar;
  const int tab_off = 1 + (1 << (log_n + log_d));
  const int passes = (log_n + LOGR - 1) / LOGR;
  fft_passes<LOGN>(passes, [&](int p) {
    const int lo = p * LOGR, hi = min(lo + LOGR, log_n);
    const int s = min(lo, log_n - LOGR);
    const bool last = p == passes - 1;
#pragma unroll 1
    for (int h = 0; h < G; ++h) {
      const int u = t + h * blockDim.x;
      V v[R];
      if (p == 0) {
        static_for<0, R>([&](auto i) {
          v[i] = P::load(x, off + ((long long)u << LOGR) +
                                decltype(i)::value);
        });
      } else {
        radix_get<V, LOGR>(sm, v, u, s);
      }
      fft_radix_inv_pass<P, LOGR>(
          v, lo - s, hi - s - (fused && last),
          radix_inv_g(shard, log_n, log_n + log_d, s, u, LOGR), tab,
          tab_off);
      if (!last) {
        radix_put<V, LOGR>(sm, v, u, s);
        continue;
      }
      if (fused) {
        const V w = P::scale(P::load(tab, (1 << log_n) - 1), sc);
        static_for<0, R / 2>([&](auto i) {
          const V a = v[i];
          const V b = v[i + R / 2];
          v[i] = P::scale(P::add(a, b), sc);
          v[i + R / 2] = P::mul_full(P::sub(a, b), w);
        });
      }
      static_for<0, R>([&](auto i) {
        P::store(y, off + u + (decltype(i)::value << s), v[i]);
      });
    }
    if (!last) __syncthreads();
  });
}

// The radix walk's shape for a policy: R = 8 from n = 8 on (2 below), one
// group a thread up to P::THREADS groups, two beyond (double-float at
// 2^13: 512 threads). In complex double and float, log_n is a constant of
// the instantiation from 2^10 to 2^13 and the passes unroll at compile
// time; in double-float they do not: its butterfly is about 120
// instructions, and a fully unrolled 2^13 walk ran slower than the stage
// walk (PERF.md's findings). f(Index<LOGR>{}, Index<G>{}, Index<LOGN>{}).
template <class P>
constexpr bool fft_unrolled() {
  return !std::is_same<P, DfP>::value;
}

template <class P, typename F>
static int fft_with_shape(int log_n, F&& f) {
  constexpr int G13 = (1 << 10) / P::THREADS;
  if constexpr (fft_unrolled<P>()) {
    switch (log_n) {
      case 13:
        return f(Index<3>{}, Index<G13>{}, Index<13>{});
      case 12:
        return f(Index<3>{}, Index<1>{}, Index<12>{});
      case 11:
        return f(Index<3>{}, Index<1>{}, Index<11>{});
      case 10:
        return f(Index<3>{}, Index<1>{}, Index<10>{});
    }
  } else {
    if (log_n == 13) return f(Index<3>{}, Index<G13>{}, Index<0>{});
  }
  if (log_n >= 3) return f(Index<3>{}, Index<1>{}, Index<0>{});
  return f(Index<1>{}, Index<1>{}, Index<0>{});
}

// ---- K12: the stage walk (several transforms per CTA) -----------------------

// `chunks` whole transforms of n = 2^log_n, `polys_per_cta` per CTA, the
// last CTA ragged.
template <class P>
__global__ void __launch_bounds__(P::THREADS)
    fft_block_kernel(Ptrs x, Ptrs y, Ptrs tab, typename P::S s,
                     int has_scalar, int forward, int log_n, int chunks,
                     int polys_per_cta) {
  using V = typename P::V;
  extern __shared__ __align__(16) unsigned char fft_smem[];
  V* v = reinterpret_cast<V*>(fft_smem);
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = min(polys_per_cta, (int)(chunks - first));
  const int count = polys << log_n;
  const long long offset = first << log_n;
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    v[i] = P::load(x, offset + i);
  __syncthreads();
  const int log_half = log_n - 1;
  const int half_mask = (1 << log_half) - 1;
  const int total = polys << log_half;
  if (forward) {
    for (int log_m = 0; log_m < log_n; ++log_m) {
      const int log_t = log_half - log_m;
      const int t = 1 << log_t;
      const bool scaled = t == 1 && has_scalar;
      for (int g = threadIdx.x; g < total; g += blockDim.x) {
        const int j = g & half_mask;
        const int k = j >> log_t;
        const int i0 = ((g >> log_half) << log_n) + (k << (log_t + 1)) +
                       (j & (t - 1));
        V w = P::load(tab, (1 << log_m) + k);
        V xs = v[i0];
        if (scaled) {
          w = P::scale(w, s);
          xs = P::scale(xs, s);
        }
        const V tt = P::mul(v[i0 + t], w);
        v[i0] = P::add(xs, tt);
        v[i0 + t] = P::sub(xs, tt);
      }
      __syncthreads();
    }
  } else {
    // Every stage, except a final stage that carries the scalar.
    const int n = 1 << log_n;
    const int stages = has_scalar ? log_half : log_n;
    for (int log_t = 0; log_t < stages; ++log_t) {
      const int t = 1 << log_t;
      const int first_tw = n + 1 - (n >> log_t);
      for (int g = threadIdx.x; g < total; g += blockDim.x) {
        const int j = g & half_mask;
        const int k = j >> log_t;
        const int i0 = ((g >> log_half) << log_n) + (k << (log_t + 1)) +
                       (j & (t - 1));
        const V a = v[i0];
        const V b = v[i0 + t];
        v[i0] = P::add(a, b);
        v[i0 + t] = P::mul(P::sub(a, b), P::load(tab, first_tw + k));
      }
      __syncthreads();
    }
    if (has_scalar) {
      const int half = 1 << log_half;
      const V w = P::scale(P::load(tab, n - 1), s);
      for (int g = threadIdx.x; g < total; g += blockDim.x) {
        const int i0 = ((g >> log_half) << log_n) + (g & half_mask);
        const V a = v[i0];
        const V b = v[i0 + half];
        v[i0] = P::scale(P::add(a, b), s);
        v[i0 + half] = P::mul_full(P::sub(a, b), w);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    P::store(y, offset + i, v[i]);
}

// ---- K13: the cross pass ----------------------------------------------------

// x, y: (batch, D, 2^log_b); thread g of batch * 2^log_b owns the D
// coefficients at offset g mod 2^log_b. Forward: the stages with m < D
// blocks (stride >= 2^log_b), block k pairing shards 2*half*k + i and
// 2*half*k + i + half with table[m + k]. Inverse: the stages of stride
// 2^log_b .. N/4, then the final stage (stride N/2, table[N - 1]) with the
// scalar fused where there is one. The global stage with m blocks reads
// table[N + 1 - 2m + k].
template <class P, int LOG_D>
__global__ void __launch_bounds__(CROSS_THREADS)
    fft_cross_kernel(Ptrs x, Ptrs y, Ptrs tab, typename P::S s,
                     int has_scalar, int forward, int log_b,
                     long long threads) {
  using V = typename P::V;
  constexpr int D = 1 << LOG_D;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= threads) return;
  const long long big_n = 1LL << (log_b + LOG_D);
  const long long base =
      ((g >> log_b) << (log_b + LOG_D)) + (g & ((1LL << log_b) - 1));
  V v[D];
  static_for<0, D>([&](auto d) {
    v[d] = P::load(x, base + ((long long)decltype(d)::value << log_b));
  });
  if (forward) {
    static_for<0, LOG_D>([&](auto st) {
      constexpr int m = 1 << decltype(st)::value;
      constexpr int half = D / (2 * m);
      static_for<0, m>([&](auto k) {
        constexpr int first = 2 * half * decltype(k)::value;
        const V w = P::load(tab, m + decltype(k)::value);
        static_for<0, half>([&](auto i) {
          const V tt = P::mul(v[first + i + half], w);
          const V a = v[first + i];
          v[first + i] = P::add(a, tt);
          v[first + i + half] = P::sub(a, tt);
        });
      });
    });
  } else {
    static_for<0, LOG_D - 1>([&](auto st) {
      constexpr int half = 1 << decltype(st)::value;
      constexpr int m = D / (2 * half);
      static_for<0, m>([&](auto k) {
        constexpr int first = 2 * half * decltype(k)::value;
        const V w = P::load(tab, big_n + 1 - 2 * m + decltype(k)::value);
        static_for<0, half>([&](auto i) {
          const V a = v[first + i];
          const V b = v[first + i + half];
          v[first + i] = P::add(a, b);
          v[first + i + half] = P::mul(P::sub(a, b), w);
        });
      });
    });
    const V w = P::load(tab, big_n - 1);
    if (has_scalar) {
      const V ws = P::scale(w, s);
      static_for<0, D / 2>([&](auto i) {
        const V a = v[i];
        const V b = v[i + D / 2];
        v[i] = P::scale(P::add(a, b), s);
        v[i + D / 2] = P::mul_full(P::sub(a, b), ws);
      });
    } else {
      static_for<0, D / 2>([&](auto i) {
        const V a = v[i];
        const V b = v[i + D / 2];
        v[i] = P::add(a, b);
        v[i + D / 2] = P::mul(P::sub(a, b), w);
      });
    }
  }
  static_for<0, D>([&](auto d) {
    P::store(y, base + ((long long)decltype(d)::value << log_b), v[d]);
  });
}

// ---- launches ---------------------------------------------------------------

// K12 with one transform or block per CTA: the radix walk.
template <class P>
static int launch_radix(Ptrs x, Ptrs y, Ptrs tab, double s_hi, double s_lo,
                        int has_scalar, int forward, int log_n, int log_d,
                        int chunks, cudaStream_t stream) {
  return fft_with_shape<P>(log_n, [&](auto logr, auto g, auto logn) {
    constexpr int LOGR = decltype(logr)::value, G = decltype(g)::value;
    constexpr int LOGN = decltype(logn)::value;
    const size_t smem = ((size_t)1 << log_n) * sizeof(typename P::V);
    const int threads = (1 << log_n) / (G << LOGR);
    const typename P::S sc = P::scalar(s_hi, s_lo);
    cudaError_t err;
    if (forward) {
      auto kernel = fft_radix_fwd_kernel<P, LOGR, G, LOGN>;
      err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<chunks, threads, smem, stream>>>(x, y, tab, sc, has_scalar,
                                                log_n, log_d);
    } else {
      auto kernel = fft_radix_inv_kernel<P, LOGR, G, LOGN>;
      err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return (int)err;
      kernel<<<chunks, threads, smem, stream>>>(x, y, tab, sc, has_scalar,
                                                log_n, log_d);
    }
    return (int)cudaGetLastError();
  });
}

// K12 with several transforms per CTA: the stage walk.
template <class P>
static int launch_block(Ptrs x, Ptrs y, Ptrs tab, double s_hi, double s_lo,
                        int has_scalar, int forward, int log_n, int chunks,
                        int polys_per_cta, cudaStream_t stream) {
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(typename P::V);
  cudaError_t err = allow_smem(fft_block_kernel<P>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long butterflies = (long long)polys_per_cta << (log_n - 1);
  const int threads =
      butterflies >= P::THREADS ? P::THREADS : (int)butterflies;
  const int grid = (chunks + polys_per_cta - 1) / polys_per_cta;
  fft_block_kernel<P><<<grid, threads, smem, stream>>>(
      x, y, tab, P::scalar(s_hi, s_lo), has_scalar, forward, log_n, chunks,
      polys_per_cta);
  return (int)cudaGetLastError();
}

template <class P>
static int launch_k12(Ptrs x, Ptrs y, Ptrs tab, double s_hi, double s_lo,
                      int has_scalar, int forward, int log_n, int log_d,
                      int chunks, int polys_per_cta, cudaStream_t stream) {
  if (polys_per_cta == 1)
    return launch_radix<P>(x, y, tab, s_hi, s_lo, has_scalar, forward, log_n,
                           log_d, chunks, stream);
  if (log_d != 0) return (int)cudaErrorInvalidValue;
  return launch_block<P>(x, y, tab, s_hi, s_lo, has_scalar, forward, log_n,
                         chunks, polys_per_cta, stream);
}

// The cross launch for D = 2^log_d, found by walking LOG_D = 1 .. 4.
template <class P, int LOG_D>
static int launch_cross(Ptrs x, Ptrs y, Ptrs tab, double s_hi, double s_lo,
                        int has_scalar, int forward, int log_b, int log_d,
                        int batch, cudaStream_t stream) {
  if (log_d != LOG_D) {
    if constexpr (LOG_D < 4) {
      return launch_cross<P, LOG_D + 1>(x, y, tab, s_hi, s_lo, has_scalar,
                                        forward, log_b, log_d, batch, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  const long long threads = (long long)batch << log_b;
  const long long grid = (threads + CROSS_THREADS - 1) / CROSS_THREADS;
  fft_cross_kernel<P, LOG_D><<<(unsigned)grid, CROSS_THREADS, 0, stream>>>(
      x, y, tab, P::scalar(s_hi, s_lo), has_scalar, forward, log_b, threads);
  return (int)cudaGetLastError();
}

static Ptrs ptrs(const void* a, const void* b, const void* c, const void* d) {
  return Ptrs{{a, b, c, d}};
}

// prec: 0 f64, 1 single, 2 double-float. x*, y*, t*: the planes of the
// input, output and twiddle table (only the first of each in f64 and
// single, which are interleaved (re, im)). The scalar is (s_hi, s_lo): a
// double in f64, a float's value in single, a double-float's two floats.

// K12: `chunks` blocks of 2^log_n, each a whole transform (log_d = 0) or
// one of the 2^log_d blocks of a split transform (polys_per_cta = 1).
extern "C" int hexl_fft_block(int prec, const void* x0, const void* x1,
                              const void* x2, const void* x3, void* y0,
                              void* y1, void* y2, void* y3, const void* t0,
                              const void* t1, const void* t2, const void* t3,
                              double s_hi, double s_lo, int has_scalar,
                              int forward, int log_n, int log_d, int chunks,
                              int polys_per_cta, cudaStream_t stream) {
  if (log_n < 1 || log_n > FFT_LOG_BLOCK) return (int)cudaErrorInvalidValue;
  const Ptrs x = ptrs(x0, x1, x2, x3), y = ptrs(y0, y1, y2, y3),
             t = ptrs(t0, t1, t2, t3);
  if (prec == 0)
    return launch_k12<F64>(x, y, t, s_hi, s_lo, has_scalar, forward, log_n,
                           log_d, chunks, polys_per_cta, stream);
  if (prec == 1)
    return launch_k12<F32>(x, y, t, s_hi, s_lo, has_scalar, forward, log_n,
                           log_d, chunks, polys_per_cta, stream);
  return launch_k12<DfP>(x, y, t, s_hi, s_lo, has_scalar, forward, log_n,
                         log_d, chunks, polys_per_cta, stream);
}

// K13: `batch` transforms of 2^(log_b + log_d) coefficients.
extern "C" int hexl_fft_cross(int prec, const void* x0, const void* x1,
                              const void* x2, const void* x3, void* y0,
                              void* y1, void* y2, void* y3, const void* t0,
                              const void* t1, const void* t2, const void* t3,
                              double s_hi, double s_lo, int has_scalar,
                              int forward, int log_b, int log_d, int batch,
                              cudaStream_t stream) {
  const Ptrs x = ptrs(x0, x1, x2, x3), y = ptrs(y0, y1, y2, y3),
             t = ptrs(t0, t1, t2, t3);
  if (prec == 0)
    return launch_cross<F64, 1>(x, y, t, s_hi, s_lo, has_scalar, forward,
                                log_b, log_d, batch, stream);
  if (prec == 1)
    return launch_cross<F32, 1>(x, y, t, s_hi, s_lo, has_scalar, forward,
                                log_b, log_d, batch, stream);
  return launch_cross<DfP, 1>(x, y, t, s_hi, s_lo, has_scalar, forward,
                              log_b, log_d, batch, stream);
}
