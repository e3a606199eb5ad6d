// K5 and K6: the two passes of the NTT above 2^14 (the on-chip split of
// hexl_tpu/ntt/hier.py), in a u64 and a u32 (q < 2^30) instantiation each.
//
// A transform of degree N = D * 2^14 (D = 2 .. 64) is viewed as D
// contiguous shards of LOCAL = 2^14 coefficients. The forward stages of
// stride t >= LOCAL pair coefficients at equal offsets of two shards; the
// rest pair coefficients within one shard. So the forward runs the cross
// pass K5 and then the local pass K6; the inverse runs K6 and then K5,
// which ends with the global final stage fused with N^-1. Both passes read
// the plan's flat twiddle tables (no per-shard copies).
//
// K5 (cross pass) replaces hier.py::_cross_call. Thread j of a polynomial
// holds the D coefficients at local offset j (2^14 apart) in registers and
// runs the log2(D) cross stages on them, fully unrolled at compile time
// (a template on log2 D);
// neighbouring threads read and write neighbouring addresses. The D - 1
// forward twiddles (rop[1 .. D-1]) or the D - 2 cross-stage inverse
// twiddles are staged in shared memory. The inverse then runs the global
// final stage with N^-1 and the OMF reduction before the store.
//
// K6 (local pass) replaces hier.py::_local_call: the kernels of
// ntt_block.cuh with log_d = log2(D), one shard per CTA, the shard's
// twiddles read at its offset in the flat tables. The forward applies the
// OMF reduction; the inverse stops before the global final stage. With
// D = 1 the same kernels are K1 (u64) and K7 (u32).
//
// What bounds them on an H100: each pass reads and writes every coefficient
// once (16 bytes per coefficient, the tensors being int64 in both
// regimes), against log2(D) butterflies per coefficient pair in K5 and
// 14 in K6. K5 is bound by bytes; K6 by its multiplies at 64 bits, as K1.
// The design keeps each pass to one load and one store of each
// coefficient. At D = 64 the u64 K5 holds 64 coefficients (128 registers)
// per thread: the -Xptxas -v report shows whether that spills.
#include "ntt_block.cuh"

constexpr int LOG_LOCAL = 14;
constexpr int CROSS_THREADS = 128;

// A loop index known at compile time.
template <int I>
struct Index {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(i) for i = I .. N-1, each i an Index: every index into a thread's
// coefficient array is a constant of the program, so the array stays in
// registers whatever the unroller does (a #pragma unroll loop left the
// inverse's array on the stack from D = 32 on).
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Index<I>{});
    static_for<I + 1, N>(f);
  }
}

// v[d] = x[base + d * 2^14] (narrowed to W), and the store back.
template <int D, typename W>
__device__ __forceinline__ void load_column(W (&v)[D], const u64* x,
                                            long long base) {
  static_for<0, D>([&](auto d) {
    v[d] = (W)x[base + ((long long)decltype(d)::value << LOG_LOCAL)];
  });
}

template <int D, typename W>
__device__ __forceinline__ void store_column(const W (&v)[D], u64* y,
                                             long long base) {
  static_for<0, D>([&](auto d) {
    y[base + ((long long)decltype(d)::value << LOG_LOCAL)] = v[d];
  });
}

// x, y: (batch, D, 2^14) with D = 2^LOG_D; thread g of batch * 2^14 owns
// column g.
template <typename W, int LOG_D>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ rop,
                     const u64* __restrict__ prop, u64 q64) {
  constexpr int D = 1 << LOG_D;
  __shared__ W tw[D], twp[D];
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    tw[i] = (W)rop[i];
    twp[i] = (W)prop[i];
  }
  __syncthreads();
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long base =
      ((g >> LOG_LOCAL) * D << LOG_LOCAL) + (g & ((1 << LOG_LOCAL) - 1));
  const W q = (W)q64;
  const W two_q = 2 * q;
  W v[D];
  load_column(v, x, base);
  // The global stage with m blocks (stride t = (D/(2m)) * 2^14): block k
  // pairs shards 2*half*k + i and 2*half*k + i + half, twiddle rop[m + k].
  static_for<0, LOG_D>([&](auto s) {
    constexpr int m = 1 << decltype(s)::value;
    constexpr int half = D / (2 * m);
    static_for<0, m>([&](auto k) {
      constexpr int first = 2 * half * decltype(k)::value;
      static_for<0, half>([&](auto i) {
        fwd_butterfly(v[first + i], v[first + i + half], tw[m + k],
                      twp[m + k], q, two_q);
      });
    });
  });
  store_column(v, y, base);
}

// irop_cross/pirop_cross point at the first cross stage (stride 2^14) of
// the stage-major inverse table; the stage with m blocks starts D - 2m
// entries later.
template <typename W, int LOG_D>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ irop_cross,
                     const u64* __restrict__ pirop_cross, u64 q64,
                     InvFinal<W> fin, int omf) {
  constexpr int D = 1 << LOG_D;
  __shared__ W tw[D], twp[D];
  for (int i = threadIdx.x; i < D - 2; i += blockDim.x) {
    tw[i] = (W)irop_cross[i];
    twp[i] = (W)pirop_cross[i];
  }
  __syncthreads();
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long base =
      ((g >> LOG_LOCAL) * D << LOG_LOCAL) + (g & ((1 << LOG_LOCAL) - 1));
  const W q = (W)q64;
  const W two_q = 2 * q;
  W v[D];
  load_column(v, x, base);
  static_for<0, LOG_D - 1>([&](auto s) {
    constexpr int half = 1 << decltype(s)::value;
    constexpr int m = D / (2 * half);
    static_for<0, m>([&](auto k) {
      constexpr int first = 2 * half * decltype(k)::value;
      static_for<0, half>([&](auto i) {
        inv_butterfly(v[first + i], v[first + i + half], tw[D - 2 * m + k],
                      twp[D - 2 * m + k], q, two_q);
      });
    });
  });
  // The global final stage (stride N/2) fused with N^-1, then the OMF.
  static_for<0, D / 2>([&](auto i) {
    inv_final_butterfly(v[i], v[i + D / 2], fin, q, two_q);
  });
  if (omf == 1) {
    static_for<0, D>([&](auto d) { v[d] = halve(v[d], q); });
  }
  store_column(v, y, base);
}

static int cross_grid(int batch) {
  return (int)(((long long)batch << LOG_LOCAL) / CROSS_THREADS);
}

// The launch for D = 2^log_d, found by walking LOG_D = 1 .. 6.
template <typename W, int LOG_D>
static int cross_fwd_at(int log_d, const u64* x, u64* y, const u64* rop,
                        const u64* prop, u64 q, int batch,
                        cudaStream_t stream) {
  if (log_d != LOG_D) {
    if constexpr (LOG_D < 6) {
      return cross_fwd_at<W, LOG_D + 1>(log_d, x, y, rop, prop, q, batch,
                                         stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  cross_fwd_kernel<W, LOG_D><<<cross_grid(batch), CROSS_THREADS, 0, stream>>>(
      x, y, rop, prop, q);
  return (int)cudaGetLastError();
}

template <typename W, int LOG_D>
static int cross_inv_at(int log_d, const u64* x, u64* y,
                        const u64* irop_cross, const u64* pirop_cross, u64 q,
                        const InvFinal<W>& fin, int batch, int omf,
                        cudaStream_t stream) {
  if (log_d != LOG_D) {
    if constexpr (LOG_D < 6) {
      return cross_inv_at<W, LOG_D + 1>(log_d, x, y, irop_cross, pirop_cross, q,
                                    fin, batch, omf, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  cross_inv_kernel<W, LOG_D><<<cross_grid(batch), CROSS_THREADS, 0, stream>>>(
      x, y, irop_cross, pirop_cross, q, fin, omf);
  return (int)cudaGetLastError();
}

// K5. word is 64 or 32; for 32 the precon tables and constants are the
// plan's precon32 ones.
extern "C" int hexl_cross_fwd(const u64* x, u64* y, const u64* rop,
                              const u64* prop, u64 q, int log_d, int batch,
                              int word, cudaStream_t stream) {
  if (word == 32)
    return cross_fwd_at<u32, 1>(log_d, x, y, rop, prop, q, batch, stream);
  return cross_fwd_at<u64, 1>(log_d, x, y, rop, prop, q, batch, stream);
}

extern "C" int hexl_cross_inv(const u64* x, u64* y, const u64* irop_cross,
                              const u64* pirop_cross, u64 q, u64 inv_n,
                              u64 inv_n_precon, u64 inv_n_w,
                              u64 inv_n_w_precon, int log_d, int batch,
                              int omf, int word, cudaStream_t stream) {
  if (word == 32) {
    const InvFinal<u32> fin = {(u32)inv_n, (u32)inv_n_precon, (u32)inv_n_w,
                               (u32)inv_n_w_precon};
    return cross_inv_at<u32, 1>(log_d, x, y, irop_cross, pirop_cross, q, fin,
                                batch, omf, stream);
  }
  const InvFinal<u64> fin = {inv_n, inv_n_precon, inv_n_w, inv_n_w_precon};
  return cross_inv_at<u64, 1>(log_d, x, y, irop_cross, pirop_cross, q, fin,
                              batch, omf, stream);
}

// K6: `batch` polynomials of D = 2^log_d shards, one shard per CTA.
extern "C" int hexl_local_fwd(const u64* x, u64* y, const u64* rop,
                              const u64* prop, u64 q, int log_d, int batch,
                              int omf, int word, cudaStream_t stream) {
  const int chunks = batch << log_d;
  if (word == 32)
    return launch_fwd<u32>(x, y, rop, prop, q, LOG_LOCAL, chunks, 1, omf,
                           log_d, stream);
  return launch_fwd<u64>(x, y, rop, prop, q, LOG_LOCAL, chunks, 1, omf, log_d,
                         stream);
}

extern "C" int hexl_local_inv(const u64* x, u64* y, const u64* irop,
                              const u64* pirop, u64 q, int log_d, int batch,
                              int word, cudaStream_t stream) {
  const int chunks = batch << log_d;
  if (word == 32)
    return launch_inv<u32>(x, y, irop, pirop, q, InvFinal<u32>{}, LOG_LOCAL,
                           chunks, 1, 2, log_d, stream);
  return launch_inv<u64>(x, y, irop, pirop, q, InvFinal<u64>{}, LOG_LOCAL,
                         chunks, 1, 2, log_d, stream);
}
