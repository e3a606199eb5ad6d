// K5.rns: the cross pass of the split (ntt_hier.cu) over a whole RNS basis
// in one launch, in both of K5's forms, 64-bit only.
//
// Replaces, for the stacked transform of hexl_tpu/ntt/rns.py above 2^14,
// the TPU kernel hexl_tpu/ntt/hier.py::_cross_call vmapped over the prime
// axis. The input is a (k, batch, D, 2^14) block, row i under prime i (its
// RnsRow, rns.cuh: the modulus, the final stage's constants and the
// addresses of its plan's tables). What a row computes is the
// single-modulus K5's, bit for bit: the forward stages of stride >= 2^14,
// or the inverse ones ending with the global final stage fused with N^-1
// and the OMF; the stacked split has one group of rows (log_groups = 0,
// D <= 64) and always ends the inverse with the final stage. The inverse
// reads its row's stage-major table from the stage of stride N/D on,
// `cross_skip` entries in (the same for every row of one N).
//
// The column form (cross_col.cuh): a thread a column, the grid (column
// CTAs a row, k); every CTA's columns lie in one row, so it stages that
// row's D twiddle pairs in shared memory as the single-modulus kernel
// does, and a row's last CTA is masked where batch * 2^14 is not a
// multiple of CROSS_THREADS.
//
// The tiled form (cross_tile.cuh): persistent CTAs walking tiles through a
// ring of cp.async buffers, each CTA staging its twiddles once before the
// ring. Tiles of different rows need different twiddles. Of the three ways
// to give them (per-row groups of CTAs; restaging behind the ring's barrier
// where a CTA's next tile starts a new row; the row's D - 1 twiddle pairs
// read through the read-only cache instead of shared memory) this takes the
// first: the grid is (CTAs a row, k), the card's persistent grid (two CTAs
// an SM) split evenly over the rows (at least one CTA a row, at most one a
// tile), and each CTA walks only its row's tiles, with its row's twiddles
// staged once, as the single-modulus CTA walks the whole launch's. So the
// ring, the passes and the staging are the single-modulus kernel's, with
// no branch per tile; the split costs at most k - 1 idle CTA slots where k
// does not divide the grid (8 of 264 at k = 16). chip_smoke.py's phase 5
// times this form at (N = 2^20, k = 16, batch 1) beside the single-modulus
// tiled form at batch 16, the same bytes with one row's twiddles, which
// no choice can beat: 0.2346 against 0.2290 ms fwd + inv, 1.025x, on one
// H100 80GB HBM3 at 700 W (PERF.md row 5.rns), so (b) and (c) were not
// built.
//
// What bounds it on an H100: as K5 (ntt_hier.cu, cross_tile.cuh), the
// bytes, 16 a coefficient a direction, and at D = 64 also the issue of the
// 64-bit butterflies.
#include "cross_col.cuh"
#include "cross_tile.cuh"
#include "rns.cuh"

// Column form: row blockIdx.y's `row_columns` = batch * lc columns.
template <int S, int LOG_D>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_fwd_rns_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                         const RnsRow* __restrict__ rows, int log_lc,
                         long long row_columns) {
  const RnsRow& row = rows[blockIdx.y];
  const long long off = (long long)blockIdx.y * (row_columns << LOG_D);
  cross_fwd_columns<u64, S, LOG_D>(x + off, y + off, row.rop, row.prop,
                                   row.q, log_lc, 0, row_columns);
}

template <int S, int LOG_D>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_inv_rns_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                         const RnsRow* __restrict__ rows, long long cross_skip,
                         int omf, int log_lc, long long row_columns) {
  const RnsRow& row = rows[blockIdx.y];
  const long long off = (long long)blockIdx.y * (row_columns << LOG_D);
  cross_inv_columns<u64, S, LOG_D, true>(
      x + off, y + off, row.irop + cross_skip, row.pirop + cross_skip, row.q,
      row_final(row), omf, log_lc, 0, row_columns);
}

// K5.rns.conv: the column form's forward with the key switch's base
// conversion in its load. x is the (k, N) block of source limbs (the
// target's inverse transforms, each below its own prime); stacked row i,
// batch b of the (k, k - 1, N) output is source limb b + (b >= i), every
// limb but the i-th in order (experimental/key_switch.py `others`), each
// word reduced mod q_i from IMF = q_i by K8.reduce.rows' Barrett step
// (eltwise.cu reduce_full at OMF 1: only a word >= q_i is reduced, with
// q_barr_i = consts[4 i + 3] of ops.row_constants and the approximate
// quotient where A), then the cross stages of cross_fwd_columns in the
// exact scheme. It replaces the gather of the limbs into the block, the
// block's reduction (K8.reduce.rows) and the cross pass over it: the
// limbs are read where they lie (N words each, within the L2 at the key
// switch's shapes) and the block is written once.
template <bool A, int LOG_D>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_fwd_conv_rns_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                              const RnsRow* __restrict__ rows,
                              const u64* __restrict__ consts, int log_lc,
                              long long row_columns) {
  constexpr int D = 1 << LOG_D;
  const int i = blockIdx.y;
  const RnsRow& row = rows[i];
  u64 *tw, *twp;
  stage_twiddles(tw, twp, row.rop, row.prop, D, D);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= row_columns) return;
  const long long b = g >> log_lc;
  const long long src = (b + (b >= i)) << (LOG_D + log_lc);
  const u64 q = row.q, q_barr = consts[4 * i + 3];
  u64 v[D];
  load_column(v, x + src, g & ((1LL << log_lc) - 1), log_lc);
  static_for<0, D>([&](auto d) {
    v[d] = v[d] >= q ? barrett_reduce_q<A>(v[d], q, q_barr, 1) : v[d];
  });
  column_fwd_stages<u64, EXACT, LOG_D>(v, tw, twp, 1, q, 2 * q);
  store_column(v, y + (((long long)i * row_columns) << LOG_D),
               column_base(g, LOG_D, log_lc), log_lc);
}

// Tiled form: row blockIdx.y's `row_tiles` tiles of TILE_COEFFS.
template <int S, int LOG_D>
__global__ void __launch_bounds__(TILE_THREADS)
    cross_tile_fwd_rns_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                              const RnsRow* __restrict__ rows, int log_lc,
                              long long row_tiles) {
  const RnsRow& row = rows[blockIdx.y];
  const long long off = (long long)blockIdx.y * (row_tiles << LOG_TILE);
  cross_tile_fwd_tiles<u64, S, LOG_D>(x + off, y + off, row.rop, row.prop,
                                      row.q, log_lc, 0, row_tiles);
}

template <int S, int LOG_D>
__global__ void __launch_bounds__(TILE_THREADS)
    cross_tile_inv_rns_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                              const RnsRow* __restrict__ rows,
                              long long cross_skip, int omf, int log_lc,
                              long long row_tiles) {
  const RnsRow& row = rows[blockIdx.y];
  const long long off = (long long)blockIdx.y * (row_tiles << LOG_TILE);
  cross_tile_inv_tiles<u64, S, LOG_D, true>(
      x + off, y + off, row.irop + cross_skip, row.pirop + cross_skip, row.q,
      row_final(row), omf, log_lc, 0, row_tiles);
}

// -- launches ----------------------------------------------------------------

// f(Index<S>{}) for a u64 scheme code.
template <typename F>
static int with_u64_scheme(int scheme, F&& f) {
  if (scheme == EXACT) return f(Index<EXACT>{});
  if (scheme == LEAN16) return f(Index<LEAN16>{});
  if (scheme == LEAN8) return f(Index<LEAN8>{});
  return (int)cudaErrorInvalidValue;
}

// f(Index<LOG_D>{}) for log_d in 1 .. 6.
template <int LOG_D = 1, typename F>
static int with_log_d(int log_d, F&& f) {
  if (log_d == LOG_D) return f(Index<LOG_D>{});
  if constexpr (LOG_D < 6) {
    return with_log_d<LOG_D + 1>(log_d, f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// The column form's launch over k rows of batch (2^log_d, 2^log_lc)
// blocks; FORWARD, or the inverse with the final stage.
template <bool FORWARD>
static int cross_rns_launch(const u64* x, u64* y, const RnsRow* rows, int k,
                            int log_d, int log_lc, int batch,
                            long long cross_skip, int omf, int scheme,
                            cudaStream_t stream) {
  const long long row_columns = (long long)batch << log_lc;
  const int ctas = cross_grid(row_columns);
  if (k < 1 || k > RNS_MAX_ROWS || ctas == 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, (unsigned)k);
  return with_u64_scheme(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_log_d(log_d, [&](auto ld) {
      constexpr int LOG_D = decltype(ld)::value;
      const size_t smem = cross_smem<u64>(LOG_D);
      if constexpr (FORWARD) {
        cross_fwd_rns_kernel<S, LOG_D><<<grid, CROSS_THREADS, smem, stream>>>(
            x, y, rows, log_lc, row_columns);
      } else {
        cross_inv_rns_kernel<S, LOG_D><<<grid, CROSS_THREADS, smem, stream>>>(
            x, y, rows, cross_skip, omf, log_lc, row_columns);
      }
      return (int)cudaGetLastError();
    });
  });
}

// The tiled form's grid: the persistent grid of tile_grid split over the k
// rows, at least one CTA and at most one a tile each (0 when the occupancy
// query fails).
template <typename Kernel>
static int tile_rns_ctas(Kernel kernel, size_t smem, int k,
                         long long row_tiles) {
  const int grid = tile_grid(kernel, smem, 0x7fffffffLL);
  if (grid == 0) return 0;
  const long long per_row = grid / k > 0 ? grid / k : 1;
  return (int)(per_row < row_tiles ? per_row : row_tiles);
}

template <bool FORWARD>
static int cross_tile_rns_launch(const u64* x, u64* y, const RnsRow* rows,
                                 int k, int log_d, int log_lc, int batch,
                                 long long cross_skip, int omf, int scheme,
                                 cudaStream_t stream) {
  if (k < 1 || k > RNS_MAX_ROWS || batch < 1)
    return (int)cudaErrorInvalidValue;
  return with_u64_scheme(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_log_d(log_d, [&](auto ld) {
      constexpr int LOG_D = decltype(ld)::value;
      constexpr int LOG_C = TileShape<LOG_D>::LOG_C;
      if (log_lc < LOG_C) return (int)cudaErrorInvalidValue;
      const long long row_tiles = (long long)batch << (log_lc - LOG_C);
      const size_t smem = tile_smem_bytes<u64>(LOG_D);
      auto launch = [&](auto kernel, auto&&... args) {
        const cudaError_t err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return (int)err;
        const int ctas = tile_rns_ctas(kernel, smem, k, row_tiles);
        if (ctas == 0) return (int)cudaErrorInvalidValue;
        kernel<<<dim3((unsigned)ctas, (unsigned)k), TILE_THREADS, smem,
                 stream>>>(x, y, rows, args..., row_tiles);
        return (int)cudaGetLastError();
      };
      if constexpr (FORWARD)
        return launch(cross_tile_fwd_rns_kernel<S, LOG_D>, log_lc);
      else
        return launch(cross_tile_inv_rns_kernel<S, LOG_D>, cross_skip, omf,
                      log_lc);
    });
  });
}

// The C entries: k rows of batch (2^log_d, 2^log_lc) blocks, row i under
// rows[i]; the inverse's tables start cross_skip entries into each row's
// stage-major table (the stage of stride N/D), and it ends with the final
// stage and the OMF.
extern "C" int hexl_cross_fwd_rns(const u64* x, u64* y, const void* rows,
                                  int k, int log_d, int log_lc, int batch,
                                  int scheme, cudaStream_t stream) {
  return cross_rns_launch<true>(x, y, static_cast<const RnsRow*>(rows), k,
                                log_d, log_lc, batch, 0, 1, scheme, stream);
}

extern "C" int hexl_cross_inv_rns(const u64* x, u64* y, const void* rows,
                                  int k, int log_d, int log_lc, int batch,
                                  long long cross_skip, int omf, int scheme,
                                  cudaStream_t stream) {
  return cross_rns_launch<false>(x, y, static_cast<const RnsRow*>(rows), k,
                                 log_d, log_lc, batch, cross_skip, omf,
                                 scheme, stream);
}

// K5.rns.conv's entry: x (k, 2^(log_d + log_lc)) source limbs, y the
// (k, k - 1, 2^(log_d + log_lc)) block, rows and consts (k, 4) of the k
// primes; approx takes the approximate quotient in the reduction.
extern "C" int hexl_cross_fwd_conv_rns(const u64* x, u64* y,
                                       const void* rows, const u64* consts,
                                       int k, int log_d, int log_lc,
                                       int approx, cudaStream_t stream) {
  const long long row_columns = (long long)(k - 1) << log_lc;
  const int ctas = cross_grid(row_columns);
  if (k < 2 || k > RNS_MAX_ROWS || ctas == 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, (unsigned)k);
  const RnsRow* r = static_cast<const RnsRow*>(rows);
  return with_log_d(log_d, [&](auto ld) {
    constexpr int LOG_D = decltype(ld)::value;
    const size_t smem = cross_smem<u64>(LOG_D);
    if (approx)
      cross_fwd_conv_rns_kernel<true, LOG_D>
          <<<grid, CROSS_THREADS, smem, stream>>>(x, y, r, consts, log_lc,
                                                  row_columns);
    else
      cross_fwd_conv_rns_kernel<false, LOG_D>
          <<<grid, CROSS_THREADS, smem, stream>>>(x, y, r, consts, log_lc,
                                                  row_columns);
    return (int)cudaGetLastError();
  });
}

extern "C" int hexl_cross_tile_fwd_rns(const u64* x, u64* y,
                                       const void* rows, int k, int log_d,
                                       int log_lc, int batch, int scheme,
                                       cudaStream_t stream) {
  return cross_tile_rns_launch<true>(x, y, static_cast<const RnsRow*>(rows),
                                     k, log_d, log_lc, batch, 0, 1, scheme,
                                     stream);
}

extern "C" int hexl_cross_tile_inv_rns(const u64* x, u64* y,
                                       const void* rows, int k, int log_d,
                                       int log_lc, int batch,
                                       long long cross_skip, int omf,
                                       int scheme, cudaStream_t stream) {
  return cross_tile_rns_launch<false>(x, y, static_cast<const RnsRow*>(rows),
                                      k, log_d, log_lc, batch, cross_skip,
                                      omf, scheme, stream);
}
