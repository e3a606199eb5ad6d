// K9: the RNS dyadic product of two ciphertexts, summed over a weights axis.
//
// Computes, for every modulus row m and coefficient c,
//   out = sum over w of (x0*y0, x0*y1 + x1*y0, x1*y1) mod q_m
// with x, y shaped (W, 2, M, n) and out (3, M, n). W = 1 is
// hexl_tpu/experimental/dyadic.py::dyadic_multiply (the ciphertext product
// of the SEAL shim); W > 1 is lr_mat_vec.py::lr_mat_vec_mult, whose adder
// tree sums fully reduced values by exact add_mods, so this running sum
// gives the same bits in any order. No Pallas kernel exists for either:
// the JAX package runs them as XLA-fused jnp and groups the moduli by bit
// length, because XLA needs the Barrett shift to be static. Here the
// shift, q and mu are per-row values read from `consts` (3, M): every row
// runs in one launch whatever the bit lengths.
//
// What bounds it on an H100: 32 bytes read per weight and coefficient and
// 24 written per coefficient, against four Barrett products (two 64x64
// high and two low products each) per weight: bound by bytes. A CTA row
// of the grid is one modulus, so a thread reads its row's constants once
// and walks the coefficients with neighbouring threads on neighbouring
// addresses; the three sums stay in registers across the weights.
#include "modarith.cuh"

__global__ void dyadic_kernel(const u64* __restrict__ x,
                              const u64* __restrict__ y,
                              u64* __restrict__ out,
                              const u64* __restrict__ consts, int weights,
                              int moduli, long long n) {
  const int m = blockIdx.y;
  const u64 q = consts[m];
  const u64 mu = consts[moduli + m];
  const int shift = (int)consts[2 * moduli + m];
  const long long plane = (long long)moduli * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < n; c += stride) {
    const long long e = (long long)m * n + c;
    u64 s0 = 0, s1 = 0, s2 = 0;
    for (int w = 0; w < weights; ++w) {
      const long long base = (long long)w * 2 * plane + e;
      const u64 x0 = x[base], x1 = x[base + plane];
      const u64 y0 = y[base], y1 = y[base + plane];
      const u64 p1 = halve(mult_mod_barrett(x0, y1, q, mu, shift)
                           + mult_mod_barrett(x1, y0, q, mu, shift), q);
      s0 = halve(s0 + mult_mod_barrett(x0, y0, q, mu, shift), q);
      s1 = halve(s1 + p1, q);
      s2 = halve(s2 + mult_mod_barrett(x1, y1, q, mu, shift), q);
    }
    out[e] = s0;
    out[plane + e] = s1;
    out[2 * plane + e] = s2;
  }
}

extern "C" int hexl_dyadic(const u64* x, const u64* y, u64* out,
                           const u64* consts, int weights, int moduli,
                           long long n, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long needed = (n + threads - 1) / threads;
  long long cap = (long long)sms * 8 / moduli;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(needed < cap ? needed : cap), (unsigned)moduli);
  dyadic_kernel<<<grid, threads, 0, stream>>>(x, y, out, consts, weights,
                                              moduli, n);
  return (int)cudaGetLastError();
}
