// K4: element-wise mult_mod, a grid-stride kernel.
//
// Replaces the mult_mod body of the TPU kernel
// hexl_tpu/eltwise/pallas_kernels.py::run_eltwise (a generic runner over
// zero-padded (512, 128) VMEM blocks). Each input goes through the range
// halvers of its input_mod_factor, then the single-mulhi Barrett product.
//
// What bounds it on an H100: 24 bytes per element against two 64x64 high
// and two low products; at the card's rates it is bound by bytes. The
// design reads each input once and writes each output once, neighbouring
// threads on neighbouring elements, with no padding copies.
#include "modarith.cuh"

__global__ void mult_mod_kernel(const u64* __restrict__ a,
                                const u64* __restrict__ b,
                                u64* __restrict__ out, long long count, u64 q,
                                u64 mu, int shift, int imf) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    out[i] = mult_mod_barrett(reduce_lazy(a[i], q, imf),
                              reduce_lazy(b[i], q, imf), q, mu, shift);
  }
}

extern "C" int hexl_mult_mod(const u64* a, const u64* b, u64* out,
                             long long count, u64 q, u64 mu, int shift,
                             int imf, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long needed = (count + threads - 1) / threads;
  const long long cap = (long long)sms * 8;
  const int blocks = (int)(needed < cap ? needed : cap);
  mult_mod_kernel<<<blocks, threads, 0, stream>>>(a, b, out, count, q, mu,
                                                  shift, imf);
  return (int)cudaGetLastError();
}

