// K1.rns, K2.rns and K6.rns: the radix walk of ntt_block.cuh over a whole
// RNS basis in one launch, 64-bit only.
//
// Replaces, for the stacked transform of hexl_tpu/ntt/rns.py
// (fwd_ntt_rns/inv_ntt_rns, the staged bodies vmapped over the prime
// axis), the TPU kernels it runs through: hexl_tpu/ntt/pallas_ntt.py::_run
// (K1: one polynomial a CTA), ::_packed_stage_kernel (K2: P polynomials of
// N < 2^8 a CTA) and hexl_tpu/ntt/hier.py::_local_call (K6: one 2^14 shard
// a CTA, the local pass of N > 2^14). The input is a (k, batch, N) block,
// row i under prime i; the grid is (CTAs a row, k), so a CTA takes its row
// from blockIdx.y, reads that row's RnsRow (rns.cuh: q and the final
// stage's constants into registers, the row's table addresses) and runs
// the single-modulus kernel's walk unchanged on its chunk. K2.rns packs P
// transforms of one row in a CTA; each row's last CTA is ragged and masked
// as the single-modulus K2 masks its last. Every row is bit-identical to
// the single-modulus kernel under its prime (ntt.cu, ntt_hier.cu), lazy
// outputs included: the stacked kernels and the single-modulus ones call
// the same chunk functions of ntt_block.cuh (radix_fwd_chunk,
// radix_inv_chunk, radix_packed_*_polys). They are instantiations beside
// the single-modulus ones, in the three u64 schemes; the stacked path
// never takes the single word (hexl_tpu/ntt/rns.py:13-16).
//
// What bounds them on an H100: as K1 and K6, the issue of the 64-bit
// butterflies' instructions (ntt_block.cuh), with the first load and last
// store of a wave exposed. The point of the stacked launch is the grid:
// k primes of a batch-1 transform at 2^17 are 8 CTAs each as k launches
// (132 SMs), and 8 k CTAs as one, without k launch gaps.
#include "ntt_block.cuh"
#include "rns.cuh"

// Row blockIdx.y, chunk blockIdx.x of gridDim.x a row: shard blockIdx.x mod
// 2^log_d of a transform of 2^(log_n + log_d) (log_d = 0: K1.rns).
template <int S, int LOGR, int G, int LOGN>
__global__ void __launch_bounds__(1024)
    radix_fwd_rns_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                         const RnsRow* __restrict__ rows, int log_n_arg,
                         int omf, int log_d) {
  const int log_n = LOGN ? LOGN : log_n_arg;
  const RnsRow& row = rows[blockIdx.y];
  const int shard = blockIdx.x & ((1 << log_d) - 1);
  const long long off =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) << log_n;
  radix_fwd_chunk<u64, S, LOGR, G, LOGN>(x + off, y + off, row.rop, row.prop,
                                         row.q, log_n, omf,
                                         (1 << log_d) + shard);
}

// The inverse: FINAL for a whole transform (K1.rns), not for a shard
// (K6.rns), which stops before the global final stage. The walk takes the
// tables from entry 1 + N on (radix_inv_pass).
template <int S, int LOGR, int G, int LOGN, bool FINAL>
__global__ void __launch_bounds__(1024)
    radix_inv_rns_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                         const RnsRow* __restrict__ rows, int log_n_arg,
                         int omf, int log_d) {
  const int log_n = LOGN ? LOGN : log_n_arg;
  const RnsRow& row = rows[blockIdx.y];
  const long long skip = 1 + (1LL << (log_n + log_d));
  const int shard = blockIdx.x & ((1 << log_d) - 1);
  const long long off =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) << log_n;
  radix_inv_chunk<u64, S, LOGR, G, LOGN, FINAL>(
      x + off, y + off, row.irop + skip, row.pirop + skip, row.q,
      row_final(row), log_n, omf, log_n + log_d, shard);
}

// K2.rns: row blockIdx.y's polynomials blockIdx.x P .. of row_polys, P =
// polys_per_cta a CTA; the row's last CTA may hold fewer.
template <int S, int LOGR>
__global__ void __launch_bounds__(1024)
    radix_packed_fwd_rns_kernel(const u64* __restrict__ x,
                                u64* __restrict__ y,
                                const RnsRow* __restrict__ rows, int log_n,
                                int row_polys, int polys_per_cta, int omf) {
  const RnsRow& row = rows[blockIdx.y];
  const long long in_row = (long long)blockIdx.x * polys_per_cta;
  const long long off = ((long long)blockIdx.y * row_polys + in_row)
                        << log_n;
  const int polys = (int)min((long long)polys_per_cta, row_polys - in_row);
  radix_packed_fwd_polys<S, LOGR>(x + off, y + off, row.rop, row.prop, row.q,
                                  log_n, polys, omf);
}

template <int S, int LOGR>
__global__ void __launch_bounds__(1024)
    radix_packed_inv_rns_kernel(const u64* __restrict__ x,
                                u64* __restrict__ y,
                                const RnsRow* __restrict__ rows, int log_n,
                                int row_polys, int polys_per_cta, int omf) {
  const RnsRow& row = rows[blockIdx.y];
  const long long skip = 1 + (1LL << log_n);
  const long long in_row = (long long)blockIdx.x * polys_per_cta;
  const long long off = ((long long)blockIdx.y * row_polys + in_row)
                        << log_n;
  const int polys = (int)min((long long)polys_per_cta, row_polys - in_row);
  radix_packed_inv_polys<S, LOGR>(x + off, y + off, row.irop + skip,
                                  row.pirop + skip, row.q, row_final(row),
                                  log_n, polys, omf);
}

// -- launches ----------------------------------------------------------------

// The grid of k rows of `row_ctas` CTAs, or false where it does not fit.
static bool rns_grid(int k, long long row_ctas, dim3& grid) {
  if (k < 1 || k > RNS_MAX_ROWS || row_ctas < 1 || row_ctas > 0x7fffffffLL)
    return false;
  grid = dim3((unsigned)row_ctas, (unsigned)k);
  return true;
}

// The local pass's one shape: the split's 2^14 shards (G = 2, log_n a
// constant), as K6 runs them.
template <typename F>
static int with_local_shape(int log_n, F&& f) {
  if (log_n != 14) return (int)cudaErrorInvalidValue;
  return f(Index<3>{}, Index<2>{}, Index<14>{});
}

// K1.rns (log_d = 0, every shape of with_shape) or K6.rns's forward
// (log_d > 0, 2^14 shards): `chunks` chunks of 2^log_n a row.
static int launch_rns_fwd(int scheme, const u64* x, u64* y,
                          const RnsRow* rows, int k, int log_n,
                          long long chunks, int omf, int log_d,
                          cudaStream_t stream) {
  dim3 grid;
  if (!rns_grid(k, chunks, grid) || (log_d > 0 && log_n != 14))
    return (int)cudaErrorInvalidValue;
  return with_scheme<u64>(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_shape<u64>(log_n, false, [&](auto logr, auto g, auto logn) {
      constexpr int LOGR = decltype(logr)::value, G = decltype(g)::value;
      constexpr int LOGN = decltype(logn)::value;
      const size_t smem = ((size_t)1 << log_n) * sizeof(u64);
      const int err =
          (int)allow_smem(radix_fwd_rns_kernel<S, LOGR, G, LOGN>, smem);
      if (err != 0) return err;
      radix_fwd_rns_kernel<S, LOGR, G, LOGN><<<grid, (1 << log_n) / (G << LOGR), smem, stream>>>(
          x, y, rows, log_n, omf, log_d);
      return (int)cudaGetLastError();
    });
  });
}

template <bool FINAL, typename Shape>
static int launch_rns_inv(int scheme, const u64* x, u64* y,
                          const RnsRow* rows, int k, int log_n,
                          long long chunks, int omf, int log_d,
                          Shape&& with_shape_of, cudaStream_t stream) {
  dim3 grid;
  if (!rns_grid(k, chunks, grid)) return (int)cudaErrorInvalidValue;
  return with_scheme<u64>(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_shape_of(log_n, [&](auto logr, auto g, auto logn) {
      constexpr int LOGR = decltype(logr)::value, G = decltype(g)::value;
      constexpr int LOGN = decltype(logn)::value;
      const size_t smem = ((size_t)1 << log_n) * sizeof(u64);
      const int err = (int)allow_smem(
          radix_inv_rns_kernel<S, LOGR, G, LOGN, FINAL>, smem);
      if (err != 0) return err;
      radix_inv_rns_kernel<S, LOGR, G, LOGN, FINAL><<<grid, (1 << log_n) / (G << LOGR), smem, stream>>>(
          x, y, rows, log_n, omf, log_d);
      return (int)cudaGetLastError();
    });
  });
}

// K2.rns: polys_per_cta transforms of a row a CTA, as K2's launch.
template <bool FORWARD>
static int launch_rns_packed(int scheme, const u64* x, u64* y,
                             const RnsRow* rows, int k, int log_n,
                             int batch, int polys_per_cta, int omf,
                             cudaStream_t stream) {
  dim3 grid;
  if (polys_per_cta < 2 ||
      !rns_grid(k, ((long long)batch + polys_per_cta - 1) / polys_per_cta,
                grid))
    return (int)cudaErrorInvalidValue;
  return with_scheme<u64>(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_packed_shape(log_n, polys_per_cta, [&](auto logr,
                                                       int threads,
                                                       size_t smem) {
      constexpr int LOGR = decltype(logr)::value;
      if constexpr (FORWARD) {
        const int err =
            (int)allow_smem(radix_packed_fwd_rns_kernel<S, LOGR>, smem);
        if (err != 0) return err;
        radix_packed_fwd_rns_kernel<S, LOGR><<<grid, threads, smem, stream>>>(
            x, y, rows, log_n, batch, polys_per_cta, omf);
      } else {
        const int err =
            (int)allow_smem(radix_packed_inv_rns_kernel<S, LOGR>, smem);
        if (err != 0) return err;
        radix_packed_inv_rns_kernel<S, LOGR><<<grid, threads, smem, stream>>>(
            x, y, rows, log_n, batch, polys_per_cta, omf);
      }
      return (int)cudaGetLastError();
    });
  });
}

// The whole transform of a (k, batch, 2^log_n) block, log_n <= 14, row i
// under rows[i]: K1.rns (polys_per_cta 1) or K2.rns (a power of two > 1).
extern "C" int hexl_ntt_fwd_rns(const u64* x, u64* y, const void* rows,
                                int k, int log_n, int batch,
                                int polys_per_cta, int omf, int scheme,
                                cudaStream_t stream) {
  const RnsRow* r = static_cast<const RnsRow*>(rows);
  if (polys_per_cta == 1)
    return launch_rns_fwd(scheme, x, y, r, k, log_n, batch, omf, 0, stream);
  return launch_rns_packed<true>(scheme, x, y, r, k, log_n, batch,
                                 polys_per_cta, omf, stream);
}

extern "C" int hexl_ntt_inv_rns(const u64* x, u64* y, const void* rows,
                                int k, int log_n, int batch,
                                int polys_per_cta, int omf, int scheme,
                                cudaStream_t stream) {
  const RnsRow* r = static_cast<const RnsRow*>(rows);
  if (polys_per_cta == 1)
    return launch_rns_inv<true>(
        scheme, x, y, r, k, log_n, batch, omf, 0,
        [](int ln, auto&& f) { return with_shape<u64>(ln, false, f); },
        stream);
  return launch_rns_packed<false>(scheme, x, y, r, k, log_n, batch,
                                  polys_per_cta, omf, stream);
}

// K6.rns: the local pass of a (k, batch, 2^(log_n + log_d)) block, the
// split's shards of 2^log_n = 2^14; the inverse stops before the global
// final stage.
extern "C" int hexl_local_fwd_rns(const u64* x, u64* y, const void* rows,
                                  int k, int log_n, int log_d, int batch,
                                  int omf, int scheme, cudaStream_t stream) {
  if (log_d < 1) return (int)cudaErrorInvalidValue;
  return launch_rns_fwd(scheme, x, y, static_cast<const RnsRow*>(rows), k,
                        log_n, (long long)batch << log_d, omf, log_d, stream);
}

extern "C" int hexl_local_inv_rns(const u64* x, u64* y, const void* rows,
                                  int k, int log_n, int log_d, int batch,
                                  int scheme, cudaStream_t stream) {
  if (log_d < 1) return (int)cudaErrorInvalidValue;
  return launch_rns_inv<false>(
      scheme, x, y, static_cast<const RnsRow*>(rows), k, log_n,
      (long long)batch << log_d, 2, log_d,
      [](int ln, auto&& f) { return with_local_shape(ln, f); }, stream);
}
