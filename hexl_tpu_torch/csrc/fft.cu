// K12 and K13: the FFT-like transform of CKKS encode/decode over the complex
// 2N-th roots (hexl_tpu/experimental/fft_like.py FFTLike), in three
// arithmetics: complex double ("f64"), complex float ("single") and complex
// double-float on four float32 planes ("double_float", df32.py).
//
// K12, the block walk, replaces hexl_tpu/experimental/pallas_fft.py::_run:
// a CTA holds whole transforms of n = 2^log_n <= 2^13 coefficients (several
// of them for small n with a large batch, as K2 does for the NTT) in shared
// memory and walks every stage between one load and one store of each
// coefficient. The forward runs to bit-reversed output with the scalar fused
// into the gap-1 stage; the inverse runs from bit-reversed input with the
// scalar fused into its final stage, which uses the full complex product
// (cdf_mul in double-float) where every other stage uses the presplit one
// (cdf_mul_ps). The stage order, twiddle indices and products are those of
// the flat walks (_stage_loop_fwd/_inv and their _df forms), so every
// output is bit-equal to the plain version in hexl_tpu_torch/experimental.
//
// Limit taken: 2^13 coefficients per CTA in every arithmetic, 16 bytes
// each for f64 and double-float (128 KB of the 227 KB a CTA may opt into);
// single precision (8 bytes) stops at 2^13 too, so that all three share one
// split. Above 2^13, K13 (the cross pass) runs the stages of stride >= 2^13:
// a thread holds the D = n / 2^13 coefficients at one offset in registers
// (D <= 16, so n <= 2^17), as K5 does for the NTT; the inverse's final
// stage, scalar and all, runs there. K12 then runs the other stages on each
// 2^13 block, reading the tables at the block's offset, as K6 does.
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
// plus the 8 of splitting each stage's twiddle once. A transform of 2^13
// f64 coefficients over its 13 stages is bound by bytes; the double-float
// one by its float32 operations. The design keeps each pass to one load
// and one store of each coefficient; tables are read through the cache,
// once per butterfly, and each butterfly splits its own twiddle (134
// operations in all), which spares the shared memory a split table would
// take.
#include "fft_arith.cuh"

constexpr int FFT_LOG_BLOCK = 13;
constexpr int CROSS_THREADS = 128;

// ---- K12: the block walk ----------------------------------------------------

// `chunks` blocks of n = 2^log_n coefficients, `polys_per_cta` per CTA (1
// for the blocks of a split transform). A block is either a whole transform
// (log_d = 0) or block `shard` of the 2^log_d contiguous blocks of one
// transform of degree N = n * 2^log_d, whose stages of stride < n it runs
// with the tables read at its offset: forward block k of the stage with m
// blocks per shard reads table[m * (2^log_d + shard) + k]; inverse block k
// at stride t reads table[N + 1 - N/t + shard * n/(2t) + k].
template <class P>
__global__ void __launch_bounds__(P::THREADS)
    fft_block_kernel(Ptrs x, Ptrs y, Ptrs tab, typename P::S s,
                     int has_scalar, int forward, int log_n, int log_d,
                     int chunks, int polys_per_cta) {
  using V = typename P::V;
  extern __shared__ __align__(16) unsigned char fft_smem[];
  V* v = reinterpret_cast<V*>(fft_smem);
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = min(polys_per_cta, (int)(chunks - first));
  const int count = polys << log_n;
  const int shard = blockIdx.x & ((1 << log_d) - 1);
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
      const int first_tw = ((1 << log_d) + shard) << log_m;
      const bool scaled = t == 1 && has_scalar;
      for (int g = threadIdx.x; g < total; g += blockDim.x) {
        const int j = g & half_mask;
        const int k = j >> log_t;
        const int i0 = ((g >> log_half) << log_n) + (k << (log_t + 1)) +
                       (j & (t - 1));
        V w = P::load(tab, first_tw + k);
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
    // Every stage of a block of a split transform; every stage of a whole
    // one, except a final stage that carries the scalar.
    const long long big_n = 1LL << (log_n + log_d);
    const bool fused_final = log_d == 0 && has_scalar;
    const int stages = fused_final ? log_half : log_n;
    for (int log_t = 0; log_t < stages; ++log_t) {
      const int t = 1 << log_t;
      const long long first_tw =
          big_n + 1 - (big_n >> log_t) + ((long long)shard << (log_half - log_t));
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
    if (fused_final) {
      const int half = 1 << log_half;
      const V w = P::scale(P::load(tab, (1 << log_n) - 1), s);
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

// A loop index known at compile time, and f(i) for i = I .. N-1, so that
// every index into a thread's coefficient array is a constant and the
// array stays in registers (the pattern of ntt_hier.cu).
template <int I>
struct Index {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Index<I>{});
    static_for<I + 1, N>(f);
  }
}

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

template <class P>
static int launch_block(Ptrs x, Ptrs y, Ptrs tab, double s_hi, double s_lo,
                        int has_scalar, int forward, int log_n, int log_d,
                        int chunks, int polys_per_cta, cudaStream_t stream) {
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(typename P::V);
  cudaError_t err = cudaFuncSetAttribute(
      fft_block_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long butterflies = (long long)polys_per_cta << (log_n - 1);
  const int threads =
      butterflies >= P::THREADS ? P::THREADS : (int)butterflies;
  const int grid = (chunks + polys_per_cta - 1) / polys_per_cta;
  fft_block_kernel<P><<<grid, threads, smem, stream>>>(
      x, y, tab, P::scalar(s_hi, s_lo), has_scalar, forward, log_n, log_d,
      chunks, polys_per_cta);
  return (int)cudaGetLastError();
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
// one of the 2^log_d blocks of a split transform.
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
    return launch_block<F64>(x, y, t, s_hi, s_lo, has_scalar, forward, log_n,
                             log_d, chunks, polys_per_cta, stream);
  if (prec == 1)
    return launch_block<F32>(x, y, t, s_hi, s_lo, has_scalar, forward, log_n,
                             log_d, chunks, polys_per_cta, stream);
  return launch_block<DfP>(x, y, t, s_hi, s_lo, has_scalar, forward, log_n,
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
