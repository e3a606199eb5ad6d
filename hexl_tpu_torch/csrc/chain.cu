// K17 and K18: chains of dependent butterflies, one element per thread.
//
// K17 replaces the TPU kernel of benchmarks/mosaic_butterfly_ab.py (its
// pallas_call at :93): `reps` dependent forward butterflies of the lean16
// scheme (hexl_tpu/ntt/jnp_ntt.py::_fwd_butterfly_lean16, the approximate
// Shoup quotient mulhi64_approx6) on two planes x, y of u64 residues, with
// one twiddle w, its precondition and q, the outputs swapped after each
// butterfly (mosaic_butterfly_ab.py:76-81). It is templated on the scheme:
// the exact Harvey instantiation is the same chain with the butterfly of
// K1 (modarith.cuh), its sibling in the A/B that says what the approximate
// quotient buys on this card.
//
// K18 replaces the TPU kernel of benchmarks/mosaic_df_bfly_ab.py (its
// pallas_call at :85): `reps` dependent double-float complex forward
// butterflies (hexl_tpu/experimental/fft_like.py::_bfly_fwd_df: X' = x + y w,
// Y' = x - y w with w presplit, cdf_mul_ps) with one unit twiddle, the
// outputs swapped after each, then a scale of both by a real (cdf_scale by
// 2^-reps). It is templated on K12's precision policies (fft_arith.cuh), so
// the same chain runs in complex double and complex float: what the
// double-float arithmetic costs where FP64 is native.
//
// What bounds them on an H100: each reads its two inputs and writes its two
// outputs once (32 bytes an element in K17 and in K18's double-float and
// f64 forms, 16 in f32) against reps butterflies an element: K17's lean16
// butterfly is an approximate 64x64 high product and two low ones (about
// 15 32-bit IMADs), so 8 of them weigh about as much as the bytes; K18's
// double-float butterfly is 134 float32 operations, which outweigh the
// bytes, while its f64 and f32 forms are bound by bytes. The design keeps
// the chain in registers (nothing but the two loads and two stores per
// element touches memory); neighbouring threads hold neighbouring elements.
#include "fft_arith.cuh"
#include "modarith.cuh"

constexpr int CHAIN_THREADS = 256;

template <int S>
__global__ void __launch_bounds__(CHAIN_THREADS)
    ntt_chain_kernel(const u64* __restrict__ x, const u64* __restrict__ y,
                     u64* __restrict__ ox, u64* __restrict__ oy, u64 w,
                     u64 wp, u64 q, int reps, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  u64 a = x[i], b = y[i];
  const u64 two_q = 2 * q;
#pragma unroll 8
  for (int r = 0; r < reps; ++r) {
    fwd_butterfly<u64, S>(a, b, w, wp, q, two_q);
    const u64 t = a;
    a = b;
    b = t;
  }
  ox[i] = a;
  oy[i] = b;
}

template <class P>
__global__ void __launch_bounds__(CHAIN_THREADS)
    df_chain_kernel(Ptrs x, Ptrs y, Ptrs ox, Ptrs oy, Ptrs wt,
                    typename P::S s, int reps, long long count) {
  using V = typename P::V;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const V w = P::load(wt, 0);
  V a = P::load(x, i), b = P::load(y, i);
#pragma unroll 8
  for (int r = 0; r < reps; ++r) {
    const V t = P::mul(b, w);
    const V nx = P::add(a, t);
    b = nx;
    a = P::sub(a, t);
  }
  P::store(ox, i, P::scale(a, s));
  P::store(oy, i, P::scale(b, s));
}

static int chain_grid(long long count) {
  const long long grid = (count + CHAIN_THREADS - 1) / CHAIN_THREADS;
  return grid > 0x7fffffffLL ? 0 : (int)grid;
}

// K17 on `count` elements of x and y; scheme is a Scheme code
// (modarith.cuh): LEAN16 (the probe's chain, q < 2^60) or EXACT.
extern "C" int hexl_ntt_chain(const u64* x, const u64* y, u64* ox, u64* oy,
                              u64 w, u64 wp, u64 q, int reps, long long count,
                              int scheme, cudaStream_t stream) {
  const int grid = chain_grid(count);
  if (grid == 0 || reps < 0) return (int)cudaErrorInvalidValue;
  if (scheme == LEAN16)
    ntt_chain_kernel<LEAN16><<<grid, CHAIN_THREADS, 0, stream>>>(
        x, y, ox, oy, w, wp, q, reps, count);
  else if (scheme == EXACT)
    ntt_chain_kernel<EXACT><<<grid, CHAIN_THREADS, 0, stream>>>(
        x, y, ox, oy, w, wp, q, reps, count);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K18 on `count` elements; prec: 0 f64, 1 single, 2 double-float, as
// hexl_fft_block's. x*, y*, ox*, oy*, w*: the planes of the inputs, the
// outputs and the one-element twiddle table (only the first of each in f64
// and single, which are interleaved (re, im)); the scale is (s_hi, s_lo).
extern "C" int hexl_df_chain(int prec, const void* x0, const void* x1,
                             const void* x2, const void* x3, const void* y0,
                             const void* y1, const void* y2, const void* y3,
                             void* ox0, void* ox1, void* ox2, void* ox3,
                             void* oy0, void* oy1, void* oy2, void* oy3,
                             const void* w0, const void* w1, const void* w2,
                             const void* w3, double s_hi, double s_lo,
                             int reps, long long count, cudaStream_t stream) {
  const int grid = chain_grid(count);
  if (grid == 0 || reps < 0) return (int)cudaErrorInvalidValue;
  const Ptrs x{{x0, x1, x2, x3}}, y{{y0, y1, y2, y3}},
      ox{{ox0, ox1, ox2, ox3}}, oy{{oy0, oy1, oy2, oy3}}, w{{w0, w1, w2, w3}};
  if (prec == 0)
    df_chain_kernel<F64><<<grid, CHAIN_THREADS, 0, stream>>>(
        x, y, ox, oy, w, F64::scalar(s_hi, s_lo), reps, count);
  else if (prec == 1)
    df_chain_kernel<F32><<<grid, CHAIN_THREADS, 0, stream>>>(
        x, y, ox, oy, w, F32::scalar(s_hi, s_lo), reps, count);
  else if (prec == 2)
    df_chain_kernel<DfP><<<grid, CHAIN_THREADS, 0, stream>>>(
        x, y, ox, oy, w, DfP::scalar(s_hi, s_lo), reps, count);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
