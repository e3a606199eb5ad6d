// K14 and K15: the digit-plane folds of the four-step (matmul) NTT
// (hexl_tpu/ntt/mxu_ntt.py; the port's pipeline is hexl_tpu_torch/ntt/
// mxu_ntt.py).
//
// Each pass of the transform is one exact int8 matrix product
// (torch._int_mm) whose int32 result holds dw digit planes of every output
// value: planes[s * n_out + o][c], value = sum_s planes[s] * 2^(7s). The
// fold turns them back into residues, one thread per output value:
// carry-normalize the dw - 1 low planes into the 64-bit low part L (at most
// 7 * 8 = 56 bits) and the top plane plus the last carry R (the JAX
// package's _carry_norm_rows), then
//   K14 (replaces mxu_ntt.py::_fold_twiddle_pallas), the pass boundary:
//       C = Shoup(L, T[o, c mod n_tail]) + Shoup(R, rhoT[o, c mod n_tail])
//       in [0, 4q), the twiddle fused with the fold of R by rho = 2^(7(dw-1));
//   K15 (replaces ::_final_pallas), the last pass:
//       V = L + Shoup(R, rho), one Barrett step with mu = floor(2^64 / q) to
//       [0, 2q), and for OMF 1 the conditional subtraction to [0, q).
// The Pallas kernels tile the tables to the block width (a Mosaic layout
// device); here a table row is read at the column's offset mod n_tail.
//
// What bounds them on an H100: dw * 4 bytes read and 8 written per value
// (dw <= 9), against two Shoup products (K14) or one and a Barrett step
// (K15): bound by bytes. Neighbouring threads take neighbouring columns, so
// every plane row, table row and output row is read or written coalesced.
#include "modarith.cuh"

// Carry-normalize the dw digit planes of output value (o, c).
__device__ __forceinline__ void carry_norm(const int* __restrict__ planes,
                                           int dw, int n_out, long long cols,
                                           int o, long long c, u64& lo,
                                           u64& r) {
  lo = 0;
  u32 carry = 0;
  for (int s = 0; s < dw - 1; ++s) {
    const u32 v = (u32)planes[((long long)s * n_out + o) * cols + c] + carry;
    lo |= (u64)(v & 127u) << (7 * s);
    carry = v >> 7;
  }
  r = (u64)((u32)planes[((long long)(dw - 1) * n_out + o) * cols + c] + carry);
}

__global__ void mxu_fold_twiddle_kernel(const int* __restrict__ planes,
                                        u64* __restrict__ out,
                                        const u64* __restrict__ tw,
                                        const u64* __restrict__ twp,
                                        const u64* __restrict__ rw,
                                        const u64* __restrict__ rwp, u64 q,
                                        int dw, int n_out, long long cols,
                                        int n_tail) {
  const long long total = (long long)n_out * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int o = (int)(i / cols);
    const long long c = i - (long long)o * cols;
    u64 lo, r;
    carry_norm(planes, dw, n_out, cols, o, c, lo, r);
    const long long t = (long long)o * n_tail + (c & (n_tail - 1));
    out[i] = shoup(lo, tw[t], twp[t], q) + shoup(r, rw[t], rwp[t], q);
  }
}

__global__ void mxu_fold_final_kernel(const int* __restrict__ planes,
                                      u64* __restrict__ out, u64 q, u64 rho,
                                      u64 rho_precon, u64 mu, int dw,
                                      int n_out, long long cols, int omf) {
  const long long total = (long long)n_out * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int o = (int)(i / cols);
    const long long c = i - (long long)o * cols;
    u64 lo, r;
    carry_norm(planes, dw, n_out, cols, o, c, lo, r);
    out[i] = barrett_reduce(lo + shoup(r, rho, rho_precon, q), q, mu, omf);
  }
}

// A grid-stride launch: enough CTAs for the work, at most 8 per SM.
static cudaError_t grid_for(long long total, int threads, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const long long needed = (total + threads - 1) / threads;
  const long long cap = (long long)sms * 8;
  *grid = (int)(needed < cap ? needed : cap);
  return cudaSuccess;
}

// K14: planes (dw * n_out, cols) int32 -> out (n_out, cols); the tables
// (n_out, n_tail), n_tail a power of two dividing cols.
extern "C" int hexl_mxu_fold_twiddle(const int* planes, u64* out,
                                     const u64* tw, const u64* twp,
                                     const u64* rw, const u64* rwp, u64 q,
                                     int dw, int n_out, long long cols,
                                     int n_tail, cudaStream_t stream) {
  const int threads = 256;
  int grid = 0;
  const cudaError_t err = grid_for((long long)n_out * cols, threads, &grid);
  if (err != cudaSuccess) return (int)err;
  mxu_fold_twiddle_kernel<<<grid, threads, 0, stream>>>(
      planes, out, tw, twp, rw, rwp, q, dw, n_out, cols, n_tail);
  return (int)cudaGetLastError();
}

// K15: planes (dw * n_out, cols) int32 -> out (n_out, cols) in [0, 2q), or
// [0, q) for omf 1.
extern "C" int hexl_mxu_fold_final(const int* planes, u64* out, u64 q,
                                   u64 rho, u64 rho_precon, u64 mu, int dw,
                                   int n_out, long long cols, int omf,
                                   cudaStream_t stream) {
  const int threads = 256;
  int grid = 0;
  const cudaError_t err = grid_for((long long)n_out * cols, threads, &grid);
  if (err != cudaSuccess) return (int)err;
  mxu_fold_final_kernel<<<grid, threads, 0, stream>>>(
      planes, out, q, rho, rho_precon, mu, dw, n_out, cols, omf);
  return (int)cudaGetLastError();
}
