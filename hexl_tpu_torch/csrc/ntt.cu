// K1 and K2: the whole negacyclic NTT of a polynomial in one CTA.
//
// Replaces the TPU kernels hexl_tpu/ntt/pallas_ntt.py::_run (K1, every
// stage of one polynomial resident in VMEM) and ::_packed_stage_kernel /
// _packed_call (K2, several small polynomials per grid step). Here both are
// one kernel per direction: a CTA holds `polys_per_cta` polynomials in
// dynamic shared memory (8N bytes each, 128 KB at N = 2^14), runs every
// stage there and writes each coefficient once. K1 is the launch with one
// polynomial per CTA; K2 the launch with P > 1 (N <= 2^12), which fills a
// CTA with up to 2^13 coefficients where the batch still gives every SM a
// CTA (ntt/cuda_ntt.py::polys_per_cta). A ragged last CTA is masked.
//
// What bounds it on an H100: reading and writing each coefficient once
// (plus the twiddle tables) moves 16 bytes per coefficient, while each of
// the N/2 log N butterflies issues one 64x64 high product and two low
// products; at N = 2^14 the two bounds are of the same order. The design
// keeps every intermediate stage out of device memory (one load, one store
// per coefficient) and reads twiddles through L1/L2. What it does not do
// yet: warp-shuffle last stages, register blocking of several stages per
// barrier, or table prefetch (bank conflicts at small strides and one
// barrier per stage remain).
#include "ntt_block.cuh"

__global__ void __launch_bounds__(1024)
    ntt_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                   const u64* __restrict__ rop, const u64* __restrict__ prop,
                   u64 q, int log_n, int batch, int polys_per_cta, int omf) {
  extern __shared__ u64 s[];
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = min(polys_per_cta, (int)(batch - first));
  const int count = polys << log_n;
  const u64* src = x + (first << log_n);
  u64* dst = y + (first << log_n);
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  block_fwd_stages(s, log_n, polys, rop, prop, q);
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    dst[i] = omf == 1 ? reduce_lazy(s[i], q, 4) : s[i];
}

__global__ void __launch_bounds__(1024)
    ntt_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                   const u64* __restrict__ irop,
                   const u64* __restrict__ pirop, u64 q, InvFinal fin,
                   int log_n, int batch, int polys_per_cta, int omf) {
  extern __shared__ u64 s[];
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = min(polys_per_cta, (int)(batch - first));
  const int count = polys << log_n;
  const u64* src = x + (first << log_n);
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  block_inv_stages(s, log_n, polys, irop, pirop, q);
  block_inv_final(s, y + (first << log_n), log_n, polys, fin, q, omf);
}

static int threads_for(int log_n, int polys_per_cta) {
  const long long butterflies = (long long)polys_per_cta << (log_n - 1);
  return butterflies >= 1024 ? 1024 : (int)butterflies;
}

extern "C" int hexl_ntt_fwd(const u64* x, u64* y, const u64* rop,
                            const u64* prop, u64 q, int log_n, int batch,
                            int polys_per_cta, int omf, cudaStream_t stream) {
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(u64);
  cudaError_t err = allow_smem(ntt_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + polys_per_cta - 1) / polys_per_cta;
  ntt_fwd_kernel<<<grid, threads_for(log_n, polys_per_cta), smem, stream>>>(
      x, y, rop, prop, q, log_n, batch, polys_per_cta, omf);
  return (int)cudaGetLastError();
}

extern "C" int hexl_ntt_inv(const u64* x, u64* y, const u64* irop,
                            const u64* pirop, u64 q, u64 inv_n,
                            u64 inv_n_precon, u64 inv_n_w, u64 inv_n_w_precon,
                            int log_n, int batch, int polys_per_cta, int omf,
                            cudaStream_t stream) {
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(u64);
  cudaError_t err = allow_smem(ntt_inv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const InvFinal fin = {inv_n, inv_n_precon, inv_n_w, inv_n_w_precon};
  const int grid = (batch + polys_per_cta - 1) / polys_per_cta;
  ntt_inv_kernel<<<grid, threads_for(log_n, polys_per_cta), smem, stream>>>(
      x, y, irop, pirop, q, fin, log_n, batch, polys_per_cta, omf);
  return (int)cudaGetLastError();
}
