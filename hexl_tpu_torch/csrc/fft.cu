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
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int FFT_LOG_BLOCK = 13;
constexpr int CROSS_THREADS = 128;

// Up to four planes of one operand: the interleaved (re, im) array in f64
// and single, the (re.hi, re.lo, im.hi, im.lo) planes in double-float.
struct Ptrs {
  const void* p[4];
};

// ---- complex double and complex float --------------------------------------

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// Interleaved (re, im) of T: complex128 for double, complex64 for float.
template <class T>
struct Cx {
  static constexpr int THREADS = 1024;
  struct alignas(2 * sizeof(T)) V {
    T re, im;
  };
  struct S {
    T v;
  };
  static S scalar(double hi, double) { return {(T)hi}; }
  static __device__ __forceinline__ V load(const Ptrs& a, long long i) {
    return static_cast<const V*>(a.p[0])[i];
  }
  static __device__ __forceinline__ void store(const Ptrs& a, long long i,
                                               const V& v) {
    static_cast<V*>(const_cast<void*>(a.p[0]))[i] = v;
  }
  static __device__ __forceinline__ V add(const V& a, const V& b) {
    return {add_rn(a.re, b.re), add_rn(a.im, b.im)};
  }
  static __device__ __forceinline__ V sub(const V& a, const V& b) {
    return {sub_rn(a.re, b.re), sub_rn(a.im, b.im)};
  }
  // (ar br - ai bi, ar bi + ai br), the JAX formula.
  static __device__ __forceinline__ V mul(const V& a, const V& b) {
    return {sub_rn(mul_rn(a.re, b.re), mul_rn(a.im, b.im)),
            add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re))};
  }
  static __device__ __forceinline__ V mul_full(const V& a, const V& b) {
    return mul(a, b);
  }
  static __device__ __forceinline__ V scale(const V& a, const S& s) {
    return {mul_rn(a.re, s.v), mul_rn(a.im, s.v)};
  }
};

using F64 = Cx<double>;
using F32 = Cx<float>;

// ---- double-float: df32.py, op for op ----------------------------------------

struct Df {
  float hi, lo;
};

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ Df norm(float s, float e) {
  const float hi = __fadd_rn(s, e);
  return {hi, __fsub_rn(e, __fsub_rn(hi, s))};
}

__device__ __forceinline__ Df df_add(const Df& x, const Df& y) {
  float s, e;
  two_sum(x.hi, y.hi, s, e);
  e = __fadd_rn(e, __fadd_rn(x.lo, y.lo));
  return norm(s, e);
}

__device__ __forceinline__ Df df_sub(const Df& x, const Df& y) {
  return df_add(x, Df{-y.hi, -y.lo});
}

__device__ __forceinline__ Df df_mul(const Df& x, const Df& y) {
  const float p = __fmul_rn(x.hi, y.hi);
  float ahi, alo, bhi, blo;
  split(x.hi, ahi, alo);
  split(y.hi, bhi, blo);
  float e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ahi, bhi), p),
                          __fmul_rn(ahi, blo)),
                __fmul_rn(alo, bhi)),
      __fmul_rn(alo, blo));
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(x.hi, y.lo), __fmul_rn(x.lo, y.hi)));
  return norm(p, e);
}

// df32._mul_ps: x*w with both splits in hand, as an unnormalized (p, e).
__device__ __forceinline__ void mul_ps(const Df& x, float x_shi, float x_slo,
                                       const Df& w, float w_shi, float w_slo,
                                       float& p, float& e) {
  p = __fmul_rn(x.hi, w.hi);
  e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(x_shi, w_shi), p),
                          __fmul_rn(x_shi, w_slo)),
                __fmul_rn(x_slo, w_shi)),
      __fmul_rn(x_slo, w_slo));
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(x.hi, w.lo), __fmul_rn(x.lo, w.hi)));
}

struct DfP {
  // Half the threads of the others: a double-float butterfly needs more
  // than the 64 registers a thread of a 1024-thread CTA may hold.
  static constexpr int THREADS = 512;
  struct __align__(16) V {
    Df re, im;
  };
  struct S {
    Df v;
  };
  static S scalar(double hi, double lo) { return {Df{(float)hi, (float)lo}}; }
  static __device__ __forceinline__ V load(const Ptrs& a, long long i) {
    return {Df{static_cast<const float*>(a.p[0])[i],
               static_cast<const float*>(a.p[1])[i]},
            Df{static_cast<const float*>(a.p[2])[i],
               static_cast<const float*>(a.p[3])[i]}};
  }
  static __device__ __forceinline__ void store(const Ptrs& a, long long i,
                                               const V& v) {
    static_cast<float*>(const_cast<void*>(a.p[0]))[i] = v.re.hi;
    static_cast<float*>(const_cast<void*>(a.p[1]))[i] = v.re.lo;
    static_cast<float*>(const_cast<void*>(a.p[2]))[i] = v.im.hi;
    static_cast<float*>(const_cast<void*>(a.p[3]))[i] = v.im.lo;
  }
  static __device__ __forceinline__ V add(const V& a, const V& b) {
    return {df_add(a.re, b.re), df_add(a.im, b.im)};
  }
  static __device__ __forceinline__ V sub(const V& a, const V& b) {
    return {df_sub(a.re, b.re), df_sub(a.im, b.im)};
  }
  // cdf_mul_ps(x, cdf_presplit(w)).
  static __device__ __forceinline__ V mul(const V& x, const V& w) {
    float xr_shi, xr_slo, xi_shi, xi_slo, wr_shi, wr_slo, wi_shi, wi_slo;
    split(x.re.hi, xr_shi, xr_slo);
    split(x.im.hi, xi_shi, xi_slo);
    split(w.re.hi, wr_shi, wr_slo);
    split(w.im.hi, wi_shi, wi_slo);
    float prr, err, pii, eii, pri, eri, pir, eir;
    mul_ps(x.re, xr_shi, xr_slo, w.re, wr_shi, wr_slo, prr, err);
    mul_ps(x.im, xi_shi, xi_slo, w.im, wi_shi, wi_slo, pii, eii);
    mul_ps(x.re, xr_shi, xr_slo, w.im, wi_shi, wi_slo, pri, eri);
    mul_ps(x.im, xi_shi, xi_slo, w.re, wr_shi, wr_slo, pir, eir);
    float sr, er, si, ei;
    two_sum(prr, -pii, sr, er);
    two_sum(pri, pir, si, ei);
    return {norm(sr, __fadd_rn(er, __fsub_rn(err, eii))),
            norm(si, __fadd_rn(ei, __fadd_rn(eri, eir)))};
  }
  // cdf_mul, the final inverse stage's product.
  static __device__ __forceinline__ V mul_full(const V& x, const V& y) {
    return {df_sub(df_mul(x.re, y.re), df_mul(x.im, y.im)),
            df_add(df_mul(x.re, y.im), df_mul(x.im, y.re))};
  }
  static __device__ __forceinline__ V scale(const V& a, const S& s) {
    return {df_mul(a.re, s.v), df_mul(a.im, s.v)};
  }
};

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
