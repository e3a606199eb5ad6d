// K3: the fused negacyclic polynomial product, one CTA per pair.
//
// Replaces the TPU kernel hexl_tpu/poly.py::_poly_mult_pallas: fwd(a) and
// fwd(b) to [0, 4q), Barrett mult_mod at IMF 4, then the inverse to [0, q),
// with no intermediate in device memory.
//
// What bounds it on an H100: it reads 16 and writes 8 bytes per
// coefficient and runs three transforms' butterflies plus one Barrett
// product per coefficient, so it does about three times the NTT's
// multiplies on 1.5 times its bytes; the multiplies weigh more than in K1.
// The space problem is that two operands at N = 2^14 need 256 KB of shared
// memory and a CTA has 227 KB. The design transforms a in shared memory,
// moves the result into registers (EPT = N / blockDim u64 per thread, 16 at
// N = 2^14 with 1024 threads), transforms b in place in the same shared
// memory, multiplies pointwise against the registers, and runs the inverse
// there. One launch computes the whole product.
#include "ntt_block.cuh"

template <int EPT>
__global__ void __launch_bounds__(1024)
    poly_mult_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                     u64* __restrict__ out, const u64* __restrict__ rop,
                     const u64* __restrict__ prop,
                     const u64* __restrict__ irop,
                     const u64* __restrict__ pirop, u64 q, u64 mu, int shift,
                     InvFinal<u64> fin, int log_n) {
  extern __shared__ u64 s[];
  const int T = blockDim.x;  // T * EPT == n
  const long long off = (long long)blockIdx.x << log_n;
  const int tid = threadIdx.x;

#pragma unroll
  for (int k = 0; k < EPT; ++k) s[tid + k * T] = a[off + tid + k * T];
  __syncthreads();
  block_fwd_stages<u64>(s, log_n, 1, rop, prop, q);
  u64 fa[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) fa[k] = reduce_lazy(s[tid + k * T], q, 4);
  __syncthreads();

#pragma unroll
  for (int k = 0; k < EPT; ++k) s[tid + k * T] = b[off + tid + k * T];
  __syncthreads();
  block_fwd_stages<u64>(s, log_n, 1, rop, prop, q);
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int i = tid + k * T;
    s[i] = mult_mod_barrett(fa[k], reduce_lazy(s[i], q, 4), q, mu, shift);
  }
  __syncthreads();

  block_inv_stages<u64>(s, log_n, 1, irop, pirop, q);
  block_inv_final<u64>(s, out + off, log_n, 1, fin, q, 1);
}

template <int EPT>
static int launch(const u64* a, const u64* b, u64* out, const u64* rop,
                  const u64* prop, const u64* irop, const u64* pirop, u64 q,
                  u64 mu, int shift, const InvFinal<u64>& fin, int log_n,
                  int batch, cudaStream_t stream) {
  const size_t smem = (size_t(1) << log_n) * sizeof(u64);
  cudaError_t err = allow_smem(poly_mult_kernel<EPT>, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (1 << log_n) / EPT;
  poly_mult_kernel<EPT><<<batch, threads, smem, stream>>>(
      a, b, out, rop, prop, irop, pirop, q, mu, shift, fin, log_n);
  return (int)cudaGetLastError();
}

// n = 2^log_n <= 2^14; threads = min(1024, n/2), so EPT = n / threads.
extern "C" int hexl_poly_mult(const u64* a, const u64* b, u64* out,
                              const u64* rop, const u64* prop,
                              const u64* irop, const u64* pirop, u64 q,
                              u64 mu, int shift, u64 inv_n, u64 inv_n_precon,
                              u64 inv_n_w, u64 inv_n_w_precon, int log_n,
                              int batch, cudaStream_t stream) {
  const InvFinal<u64> fin = {inv_n, inv_n_precon, inv_n_w, inv_n_w_precon};
  switch (log_n <= 11 ? 2 : 1 << (log_n - 10)) {
    case 2:
      return launch<2>(a, b, out, rop, prop, irop, pirop, q, mu, shift, fin,
                       log_n, batch, stream);
    case 4:
      return launch<4>(a, b, out, rop, prop, irop, pirop, q, mu, shift, fin,
                       log_n, batch, stream);
    case 8:
      return launch<8>(a, b, out, rop, prop, irop, pirop, q, mu, shift, fin,
                       log_n, batch, stream);
    case 16:
      return launch<16>(a, b, out, rop, prop, irop, pirop, q, mu, shift, fin,
                        log_n, batch, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
