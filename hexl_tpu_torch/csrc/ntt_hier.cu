// K5 and K6: the two passes of the NTT above 2^14 (the on-chip split of
// hexl_tpu/ntt/hier.py), in a u64 and a u32 (q < 2^30) instantiation each,
// and the passes of one position of the coefficient-sharded transform
// (hexl_tpu/parallel/dist_ntt.py::DistNTT), in u64.
//
// A transform of degree N = D * 2^14 (D = 2 .. 64) is viewed as D
// contiguous shards of 2^14 coefficients. The forward stages of stride
// t >= 2^14 pair coefficients at equal offsets of two shards; the rest
// pair coefficients within one shard. So the forward runs the cross pass
// K5 and then the local pass K6; the inverse runs K6 and then K5, which
// ends with the global final stage fused with N^-1. Both passes read the
// plan's flat twiddle tables (no per-shard copies).
//
// K5 (cross pass) replaces hier.py::_cross_call, and carries the cross
// stages of DistNTT (dist_ntt.py::_cross_fwd_body/_cross_inv_body, jnp on
// the TPU). It works on a (batch, D, lc) block of D rows of lc = 2^log_lc
// coefficients: thread j of a polynomial holds column j, the D
// coefficients lc apart, in registers and runs the log2(D) stages on them,
// fully unrolled at compile time (a template on log2 D); neighbouring
// threads read and write neighbouring addresses, and the last CTA is
// masked when batch * lc is not a multiple of its width. The split passes
// lc = 2^14; a DistNTT position passes its exchanged block, whose rows are
// the D shards' chunks (lc = N/D^2, down to 256/D), and a position of more
// than 2^14 coefficients passes its own shard as 2^14-coefficient rows,
// with that shard's twiddles gathered into a small table
// (hexl_tpu_torch/ntt/shard.py). The D - 1 forward twiddles
// (rop[1 .. D-1], or the gathered table) or the inverse ones are staged in
// shared memory. The inverse either ends with the global final stage, N^-1
// and the OMF reduction, or (final_stage = 0, a position's intra-shard
// stages) runs its last stage as an ordinary one with table entry D - 2.
// A thread holds at most 64 rows. A coefficient axis of more positions,
// D = A B rows, runs as two launches (hexl_tpu_torch/ntt/hier.py::cross):
// the stages across the A groups of B consecutive rows, on the (A, B lc)
// view, and those within each group, on the (A, B, lc) view with
// log_groups = log2 A, where group g reads its own twiddles of the
// whole transform's stages (the tables then hold D entries).
//
// The column form's device functions are in cross_col.cuh, which the
// stacked K5.rns (cross_rns.cu) shares; the tiled form's in cross_tile.cuh.
//
// K6 (local pass) replaces hier.py::_local_call and, for a DistNTT
// position, dist_ntt.py::DistNTT._pallas_local: the radix walk of
// ntt_block.cuh, one 2^log_n shard per CTA, the shard's twiddles read at
// its offset in the flat tables (shard_base and log_sub pick each CTA's
// shard). The forward applies the OMF reduction; the inverse stops before
// the global final stage. With D = 1 the same walk is K1 (u64).
//
// Both passes run in the exact scheme and, for u64, in the lean16 and lean8
// schemes of the JAX engine's device bodies and in the approx scheme of its
// Pallas kernels (modarith.cuh), each a template instantiation: a lean
// forward's fixup runs at the end of the local pass, a lean inverse's final
// stage in the cross pass.
//
// What bounds them on an H100: each pass reads and writes every coefficient
// once (16 bytes per coefficient, the tensors being int64 in both
// regimes), against log2(D) butterflies per coefficient pair in K5 and
// log_n in K6. K5 is bound by bytes; K6 by the issue of its butterflies'
// instructions at 64 bits, as K1 (ntt_block.cuh). The design keeps each
// pass to one load and one store of each coefficient. At D = 64 the u64
// column form holds 64 coefficients (128 registers, 254 in all) a thread,
// two CTAs an SM, and stays at 36% of its bound: there the wrapper takes
// K5's tiled form (cross_tile.cuh, its C entries below), which holds 8.
#include "cross_col.cuh"
#include "cross_tile.cuh"
#include "ntt_block.cuh"

// The most entries (rows times groups) a launch's twiddle tables hold:
// 2^11, 32 KB of u64 tables, within the 48 KB of shared memory a launch
// gets without an opt-in. A DistNTT of degree 2^20 has at most 2^10 rows.
constexpr int MAX_LOG_TABLE = 11;

// The column form's kernels: cross_col.cuh's functions on the launch's
// columns.
template <typename W, int S, int LOG_D>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ rop,
                     const u64* __restrict__ prop, u64 q64, int log_lc,
                     int log_groups, long long columns) {
  cross_fwd_columns<W, S, LOG_D>(x, y, rop, prop, q64, log_lc, log_groups,
                                 columns);
}

template <typename W, int S, int LOG_D, bool FINAL>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ irop_cross,
                     const u64* __restrict__ pirop_cross, u64 q64,
                     InvFinal<W> fin, int omf, int log_lc, int log_groups,
                     long long columns) {
  cross_inv_columns<W, S, LOG_D, FINAL>(x, y, irop_cross, pirop_cross, q64,
                                        fin, omf, log_lc, log_groups,
                                        columns);
}

// The launch for D = 2^log_d, found by walking LOG_D = 1 .. 6.
template <typename W, int S, int LOG_D>
static int cross_fwd_at(int log_d, const u64* x, u64* y, const u64* rop,
                        const u64* prop, u64 q, int log_lc, int log_groups,
                        long long columns, cudaStream_t stream) {
  if (log_d != LOG_D) {
    if constexpr (LOG_D < 6) {
      return cross_fwd_at<W, S, LOG_D + 1>(log_d, x, y, rop, prop, q, log_lc,
                                            log_groups, columns, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int grid = cross_grid(columns);
  if (grid == 0 || log_groups < 0 || LOG_D + log_groups > MAX_LOG_TABLE)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cross_smem<W>(LOG_D + log_groups);
  cross_fwd_kernel<W, S, LOG_D><<<grid, CROSS_THREADS, smem, stream>>>(
      x, y, rop, prop, q, log_lc, log_groups, columns);
  return (int)cudaGetLastError();
}

template <typename W, int S, int LOG_D>
static int cross_inv_at(int log_d, const u64* x, u64* y,
                        const u64* irop_cross, const u64* pirop_cross, u64 q,
                        const InvFinal<W>& fin, int omf, int final_stage,
                        int log_lc, int log_groups, long long columns,
                        cudaStream_t stream) {
  if (log_d != LOG_D) {
    if constexpr (LOG_D < 6) {
      return cross_inv_at<W, S, LOG_D + 1>(log_d, x, y, irop_cross,
                                           pirop_cross, q, fin, omf,
                                           final_stage, log_lc, log_groups,
                                           columns, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int grid = cross_grid(columns);
  if (grid == 0 || log_groups < 0 || LOG_D + log_groups > MAX_LOG_TABLE ||
      (final_stage && log_groups != 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = cross_smem<W>(LOG_D + log_groups);
  if (final_stage)
    cross_inv_kernel<W, S, LOG_D, true><<<grid, CROSS_THREADS, smem,
                                          stream>>>(
        x, y, irop_cross, pirop_cross, q, fin, omf, log_lc, log_groups,
        columns);
  else
    cross_inv_kernel<W, S, LOG_D, false><<<grid, CROSS_THREADS, smem,
                                           stream>>>(
        x, y, irop_cross, pirop_cross, q, fin, omf, log_lc, log_groups,
        columns);
  return (int)cudaGetLastError();
}

// K5 on `batch` blocks of (2^log_d, 2^log_lc), in groups of
// 2^log_groups consecutive blocks (see the kernels). word is 64 or 32; for
// 32 the precon tables and constants are the plan's precon32 ones. scheme
// is a Scheme code (modarith.cuh), an approximate one with word 64 only.
extern "C" int hexl_cross_fwd(const u64* x, u64* y, const u64* rop,
                              const u64* prop, u64 q, int log_d, int log_lc,
                              int log_groups, int batch, int word, int scheme,
                              cudaStream_t stream) {
  const long long columns = (long long)batch << log_lc;
  if (word == 32)
    return scheme != EXACT
               ? (int)cudaErrorInvalidValue
               : cross_fwd_at<u32, EXACT, 1>(log_d, x, y, rop, prop, q,
                                             log_lc, log_groups, columns,
                                             stream);
  return with_scheme<u64, true>(scheme, [&](auto s) {
    return cross_fwd_at<u64, decltype(s)::value, 1>(
        log_d, x, y, rop, prop, q, log_lc, log_groups, columns, stream);
  });
}

extern "C" int hexl_cross_inv(const u64* x, u64* y, const u64* irop_cross,
                              const u64* pirop_cross, u64 q, u64 inv_n,
                              u64 inv_n_precon, u64 inv_n_w,
                              u64 inv_n_w_precon, int log_d, int log_lc,
                              int log_groups, int batch, int omf,
                              int final_stage, int word, int scheme,
                              cudaStream_t stream) {
  const long long columns = (long long)batch << log_lc;
  if (word == 32) {
    const InvFinal<u32> fin = {(u32)inv_n, (u32)inv_n_precon, (u32)inv_n_w,
                               (u32)inv_n_w_precon};
    return scheme != EXACT
               ? (int)cudaErrorInvalidValue
               : cross_inv_at<u32, EXACT, 1>(log_d, x, y, irop_cross,
                                             pirop_cross, q, fin, omf,
                                             final_stage, log_lc, log_groups,
                                             columns, stream);
  }
  const InvFinal<u64> fin = {inv_n, inv_n_precon, inv_n_w, inv_n_w_precon};
  return with_scheme<u64, true>(scheme, [&](auto s) {
    return cross_inv_at<u64, decltype(s)::value, 1>(
        log_d, x, y, irop_cross, pirop_cross, q, fin, omf, final_stage,
        log_lc, log_groups, columns, stream);
  });
}

// K5's tiled form (cross_tile.cuh): the launches for D = 2^log_d, found
// by walking LOG_D = 1 .. 6, on `batch` blocks of (2^log_d, 2^log_lc) with
// lc at least a tile's columns.

template <typename W, int S, int LOG_D>
static int cross_tile_fwd_at(int log_d, const u64* x, u64* y, const u64* rop,
                             const u64* prop, u64 q, int log_lc,
                             int log_groups, int batch, cudaStream_t stream) {
  if (log_d != LOG_D) {
    if constexpr (LOG_D < 6) {
      return cross_tile_fwd_at<W, S, LOG_D + 1>(log_d, x, y, rop, prop, q,
                                                 log_lc, log_groups, batch,
                                                 stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  constexpr int LOG_C = TileShape<LOG_D>::LOG_C;
  if (log_lc < LOG_C || log_groups < 0 || LOG_D + log_groups > MAX_LOG_TABLE)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)batch << (log_lc - LOG_C);
  auto kernel = cross_tile_fwd_kernel<W, S, LOG_D>;
  const size_t smem = tile_smem_bytes<W>(LOG_D + log_groups);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = tile_grid(kernel, smem, tiles);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, TILE_THREADS, smem, stream>>>(x, y, rop, prop, q, log_lc,
                                               log_groups, tiles);
  return (int)cudaGetLastError();
}

template <typename W, int S, int LOG_D>
static int cross_tile_inv_at(int log_d, const u64* x, u64* y,
                             const u64* irop_cross, const u64* pirop_cross,
                             u64 q, const InvFinal<W>& fin, int omf,
                             int final_stage, int log_lc, int log_groups,
                             int batch, cudaStream_t stream) {
  if (log_d != LOG_D) {
    if constexpr (LOG_D < 6) {
      return cross_tile_inv_at<W, S, LOG_D + 1>(
          log_d, x, y, irop_cross, pirop_cross, q, fin, omf, final_stage,
          log_lc, log_groups, batch, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  constexpr int LOG_C = TileShape<LOG_D>::LOG_C;
  if (log_lc < LOG_C || log_groups < 0 ||
      LOG_D + log_groups > MAX_LOG_TABLE || (final_stage && log_groups != 0))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)batch << (log_lc - LOG_C);
  const size_t smem = tile_smem_bytes<W>(LOG_D + log_groups);
  auto launch = [&](auto kernel) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = tile_grid(kernel, smem, tiles);
    if (grid == 0) return (int)cudaErrorInvalidValue;
    kernel<<<grid, TILE_THREADS, smem, stream>>>(
        x, y, irop_cross, pirop_cross, q, fin, omf, log_lc, log_groups, tiles);
    return (int)cudaGetLastError();
  };
  if (final_stage) return launch(cross_tile_inv_kernel<W, S, LOG_D, true>);
  return launch(cross_tile_inv_kernel<W, S, LOG_D, false>);
}

// The tiled form's C entries: hexl_cross_fwd's and hexl_cross_inv's
// arguments, for lc at least TILE_COEFFS / D.
extern "C" int hexl_cross_tile_fwd(const u64* x, u64* y, const u64* rop,
                                   const u64* prop, u64 q, int log_d,
                                   int log_lc, int log_groups, int batch,
                                   int word, int scheme,
                                   cudaStream_t stream) {
  if (word == 32)
    return scheme != EXACT
               ? (int)cudaErrorInvalidValue
               : cross_tile_fwd_at<u32, EXACT, 1>(
                     log_d, x, y, rop, prop, q, log_lc, log_groups, batch,
                     stream);
  return with_scheme<u64, true>(scheme, [&](auto s) {
    return cross_tile_fwd_at<u64, decltype(s)::value, 1>(
        log_d, x, y, rop, prop, q, log_lc, log_groups, batch, stream);
  });
}

extern "C" int hexl_cross_tile_inv(const u64* x, u64* y,
                                   const u64* irop_cross,
                                   const u64* pirop_cross, u64 q, u64 inv_n,
                                   u64 inv_n_precon, u64 inv_n_w,
                                   u64 inv_n_w_precon, int log_d, int log_lc,
                                   int log_groups, int batch, int omf,
                                   int final_stage, int word, int scheme,
                                   cudaStream_t stream) {
  if (word == 32) {
    const InvFinal<u32> fin = {(u32)inv_n, (u32)inv_n_precon, (u32)inv_n_w,
                               (u32)inv_n_w_precon};
    return scheme != EXACT
               ? (int)cudaErrorInvalidValue
               : cross_tile_inv_at<u32, EXACT, 1>(
                     log_d, x, y, irop_cross, pirop_cross, q, fin, omf,
                     final_stage, log_lc, log_groups, batch, stream);
  }
  const InvFinal<u64> fin = {inv_n, inv_n_precon, inv_n_w, inv_n_w_precon};
  return with_scheme<u64, true>(scheme, [&](auto s) {
    return cross_tile_inv_at<u64, decltype(s)::value, 1>(
        log_d, x, y, irop_cross, pirop_cross, q, fin, omf, final_stage,
        log_lc, log_groups, batch, stream);
  });
}

// How many CTAs of K5's forward (forward != 0) or final inverse kernel at
// D = 2^log_d, exact scheme, in the column (form 0) or tiled form (1), an
// SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the
// shared memory of a launch of one group; for the tiled form at most
// TILE_CTAS_PER_SM, as its grid takes).
template <typename W, int LOG_D>
static int cross_occupancy_at(int log_d, int form, int forward, int* blocks) {
  if (log_d != LOG_D) {
    if constexpr (LOG_D < 6) {
      return cross_occupancy_at<W, LOG_D + 1>(log_d, form, forward, blocks);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (form == 0) {
    const size_t smem = cross_smem<W>(LOG_D);
    if (forward)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, cross_fwd_kernel<W, EXACT, LOG_D>, CROSS_THREADS, smem);
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, cross_inv_kernel<W, EXACT, LOG_D, true>, CROSS_THREADS, smem);
  }
  const size_t smem = tile_smem_bytes<W>(LOG_D);
  auto query = [&](auto kernel) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, kernel, TILE_THREADS, smem);
    if (TILE_CTAS_PER_SM > 0 && *blocks > TILE_CTAS_PER_SM)
      *blocks = TILE_CTAS_PER_SM;   // the persistent grid's (tile_grid)
    return (int)err;
  };
  if (forward) return query(cross_tile_fwd_kernel<W, EXACT, LOG_D>);
  return query(cross_tile_inv_kernel<W, EXACT, LOG_D, true>);
}

extern "C" int hexl_cross_occupancy(int form, int log_d, int forward,
                                    int word, int* blocks) {
  if (word == 32) return cross_occupancy_at<u32, 1>(log_d, form, forward,
                                                    blocks);
  return cross_occupancy_at<u64, 1>(log_d, form, forward, blocks);
}

// K6: `chunks` shards of 2^log_n coefficients of transforms of degree
// 2^(log_n + log_d), one per CTA; CTA b runs shard
// shard_base + (b mod 2^log_sub).
extern "C" int hexl_local_fwd(const u64* x, u64* y, const u64* rop,
                              const u64* prop, u64 q, int log_n, int log_d,
                              int shard_base, int log_sub, int chunks,
                              int omf, int word, int scheme,
                              cudaStream_t stream) {
  if (word == 32)
    return launch_radix_fwd_scheme<u32>(scheme, x, y, rop, prop, q, log_n,
                                        chunks, omf, log_d, shard_base,
                                        log_sub, stream);
  return launch_radix_fwd_scheme<u64>(scheme, x, y, rop, prop, q, log_n,
                                      chunks, omf, log_d, shard_base, log_sub,
                                      stream);
}

extern "C" int hexl_local_inv(const u64* x, u64* y, const u64* irop,
                              const u64* pirop, u64 q, int log_n, int log_d,
                              int shard_base, int log_sub, int chunks,
                              int word, int scheme, cudaStream_t stream) {
  if (word == 32)
    return launch_radix_inv_scheme<u32, false>(scheme, x, y, irop, pirop, q,
                                        InvFinal<u32>{}, log_n, chunks, 2,
                                        log_d, shard_base, log_sub, stream);
  return launch_radix_inv_scheme<u64, false>(scheme, x, y, irop, pirop, q,
                                      InvFinal<u64>{}, log_n, chunks, 2,
                                      log_d, shard_base, log_sub, stream);
}
