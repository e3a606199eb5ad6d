// K16: one radix-2 stage of the flat negacyclic NTT walk over (batch, N),
// u64. The stage runs of the stage-pipelined transform
// (hexl_tpu_torch/parallel/pipeline.py::PipelineNTT) are sequences of it.
//
// Replaces the jnp stage bodies of hexl_tpu/parallel/pipeline.py
// (PipelineNTT._fwd_stage/_inv_stage, :80-122, inside its shard_map; the
// TPU runs them as XLA-fused jnp, there is no pallas_call). The stage order,
// twiddle indexing and butterflies are those of the flat exact-Harvey walk
// (hexl_tpu_torch/ntt/torch_ntt.py::fwd_stages/inv_stages/inv_final):
// forward stage m (m blocks of stride t = N/(2m)) reads rop[m + k] for
// block k; inverse stage t reads irop[root_index(N, t) + k]; the inverse's
// last stage (t = N/2) is fused with N^-1. The wrapper passes the table
// from the stage's first entry on. `omf` is applied after the transform's
// last stage only (final_stage = 1): the forward reduces [0, 4q) to
// [0, q) for OMF 1, the inverse [0, 2q) to [0, q).
//
// One thread per butterfly pair: thread g of batch * N/2 reads x[p] and
// x[p + t] and writes y[p] and y[p + t] (x and y may be the same tensor:
// the wrapper runs a stage run's later stages in place). What bounds it on
// an H100: every stage reads and writes each coefficient once, 16 bytes a
// coefficient, against one Shoup product (3 64-bit multiplies) per pair;
// it is bound by bytes. It is the simple form: a run of stages through
// shared memory would read and write each coefficient once per run, not
// once per stage (later work).
//
// The kernel is a template on the butterfly scheme S: EXACT, or APPROX, the
// pair jnp_ntt._bflys returns for q < 2^61 when the JAX package's
// approximation is on (modarith.cuh); the inverse's last stage is the exact
// fused one in both, as pipeline.py:113 runs it.
#include "modarith.cuh"

constexpr int STAGE_THREADS = 256;

template <int S>
__global__ void __launch_bounds__(STAGE_THREADS)
    stage_kernel(const u64* x, u64* y, const u64* __restrict__ w,
                 const u64* __restrict__ wp, u64 q, InvFinal<u64> fin,
                 int log_n, int log_t, int forward, int final_stage, int omf,
                 long long pairs) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= pairs) return;
  const int log_half = log_n - 1;
  const long long j = g & ((1LL << log_half) - 1);
  const long long block = j >> log_t;
  const long long t = 1LL << log_t;
  const long long p =
      ((g >> log_half) << log_n) + (block << (log_t + 1)) + (j & (t - 1));
  const u64 two_q = 2 * q;
  u64 a = x[p];
  u64 b = x[p + t];
  if (forward) {
    fwd_butterfly<u64, S>(a, b, __ldg(w + block), __ldg(wp + block), q,
                          two_q);
    if (final_stage && omf == 1) {
      a = reduce_lazy<u64>(a, q, 4);
      b = reduce_lazy<u64>(b, q, 4);
    }
  } else if (final_stage) {
    inv_final_butterfly<u64, S>(a, b, fin, q, two_q);
    if (omf == 1) {
      a = halve(a, q);
      b = halve(b, q);
    }
  } else {
    inv_butterfly<u64, S>(a, b, __ldg(w + block), __ldg(wp + block), q,
                          two_q);
  }
  y[p] = a;
  y[p + t] = b;
}

// One stage of stride 2^log_t over `batch` transforms of N = 2^log_n.
// w/wp point at the stage's first twiddle (unused by the inverse's final
// stage, which reads fin). scheme: a Scheme code, EXACT or APPROX (q <
// 2^61).
extern "C" int hexl_stage(const u64* x, u64* y, const u64* w, const u64* wp,
                          u64 q, u64 inv_n, u64 inv_n_precon, u64 inv_n_w,
                          u64 inv_n_w_precon, int log_n, int log_t,
                          int forward, int final_stage, int omf, int batch,
                          int scheme, cudaStream_t stream) {
  const long long pairs = (long long)batch << (log_n - 1);
  const long long grid = (pairs + STAGE_THREADS - 1) / STAGE_THREADS;
  if (log_n < 1 || log_t < 0 || log_t >= log_n || grid > 0x7fffffffLL ||
      (scheme != EXACT && scheme != APPROX))
    return (int)cudaErrorInvalidValue;
  if (pairs == 0) return 0;
  const InvFinal<u64> fin = {inv_n, inv_n_precon, inv_n_w, inv_n_w_precon};
  if (scheme == APPROX)
    stage_kernel<APPROX><<<(int)grid, STAGE_THREADS, 0, stream>>>(x, y, w, wp, q, fin, log_n, log_t, forward, final_stage, omf, pairs);
  else
    stage_kernel<EXACT><<<(int)grid, STAGE_THREADS, 0, stream>>>(x, y, w, wp, q, fin, log_n, log_t, forward, final_stage, omf, pairs);
  return (int)cudaGetLastError();
}
