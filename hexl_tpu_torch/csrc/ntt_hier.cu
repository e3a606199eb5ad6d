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
// K6 (local pass) replaces hier.py::_local_call and, for a DistNTT
// position, dist_ntt.py::DistNTT._pallas_local: the radix walk of
// ntt_block.cuh, one 2^log_n shard per CTA, the shard's twiddles read at
// its offset in the flat tables (shard_base and log_sub pick each CTA's
// shard). The forward applies the OMF reduction; the inverse stops before
// the global final stage. With D = 1 the same walk is K1 (u64).
//
// Both passes run in the exact scheme and, for u64, in the lean16 and lean8
// schemes of the JAX engine's device bodies (modarith.cuh), each a
// template instantiation: a lean forward's fixup runs at the end of the
// local pass, a lean inverse's final stage in the cross pass.
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
#include "cross_tile.cuh"
#include "ntt_block.cuh"

constexpr int CROSS_THREADS = 128;
// The most entries (rows times groups) a launch's twiddle tables hold:
// 2^11, 32 KB of u64 tables, within the 48 KB of shared memory a launch
// gets without an opt-in. A DistNTT of degree 2^20 has at most 2^10 rows.
constexpr int MAX_LOG_TABLE = 11;

// v[d] = x[base + d * lc] (narrowed to W), and the store back.
template <int D, typename W>
__device__ __forceinline__ void load_column(W (&v)[D], const u64* x,
                                            long long base, int log_lc) {
  static_for<0, D>([&](auto d) {
    v[d] = (W)x[base + ((long long)decltype(d)::value << log_lc)];
  });
}

template <int D, typename W>
__device__ __forceinline__ void store_column(const W (&v)[D], u64* y,
                                             long long base, int log_lc) {
  static_for<0, D>([&](auto d) {
    y[base + ((long long)decltype(d)::value << log_lc)] = v[d];
  });
}

// Where column g of a (batch, 2^log_d, 2^log_lc) block starts.
__device__ __forceinline__ long long column_base(long long g, int log_d,
                                                 int log_lc) {
  return ((g >> log_lc) << (log_d + log_lc)) + (g & ((1LL << log_lc) - 1));
}

// The twiddle tables of a launch, staged in dynamic shared memory:
// tw[0 .. entries) and twp[0 .. entries), narrowed to W.
template <typename W>
__device__ __forceinline__ void stage_twiddles(W*& tw, W*& twp,
                                               const u64* __restrict__ w,
                                               const u64* __restrict__ wp,
                                               int entries, int capacity) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  tw = reinterpret_cast<W*>(ntt_smem);
  twp = tw + capacity;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    tw[i] = (W)w[i];
    twp[i] = (W)wp[i];
  }
  __syncthreads();
}

// x, y: (batch, D, lc) with D = 2^LOG_D; thread g of `columns` =
// batch * lc owns column g. Block b of the batch is group
// b mod G (G = 2^log_groups; G = 1 but where the rows of G consecutive
// blocks are one block of G D rows, see hexl_cross_fwd): the stage with
// m blocks reads rop/prop[m (G + group) + k] for block k, and the tables
// hold D G entries.
template <typename W, int S, int LOG_D>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ rop,
                     const u64* __restrict__ prop, u64 q64, int log_lc,
                     int log_groups, long long columns) {
  constexpr int D = 1 << LOG_D;
  W *tw, *twp;
  stage_twiddles(tw, twp, rop, prop, D << log_groups, D << log_groups);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= columns) return;
  const int groups = 1 << log_groups;
  const int base_m = groups + (int)((g >> log_lc) & (groups - 1));
  const long long base = column_base(g, LOG_D, log_lc);
  const W q = (W)q64;
  const W two_q = 2 * q;
  W v[D];
  load_column(v, x, base, log_lc);
  // The stage with m blocks (row stride D/(2m)): block k pairs rows
  // 2*half*k + i and 2*half*k + i + half, twiddle tw[m * base_m + k].
  static_for<0, LOG_D>([&](auto s) {
    constexpr int m = 1 << decltype(s)::value;
    constexpr int half = D / (2 * m);
    const int first = m * base_m;
    static_for<0, m>([&](auto k) {
      constexpr int at = 2 * half * decltype(k)::value;
      static_for<0, half>([&](auto i) {
        fwd_butterfly<W, S>(v[at + i], v[at + i + half], tw[first + k],
                            twp[first + k], q, two_q);
      });
    });
  });
  store_column(v, y, base, log_lc);
}

// irop_cross/pirop_cross hold the inverse stage with m blocks at
// [D - 2m, D - m): for the split and DistNTT's cross pass, the stage-major
// inverse table from its first cross stage on. With FINAL the last stage
// (m = 1) is the global final stage fused with N^-1, then the OMF; without
// it, an ordinary stage with entry D - 2 (a template parameter, so that
// neither form costs the other registers: at D = 64 a thread's 64 u64
// coefficients fill nearly all of them). With G = 2^log_groups groups (no
// final stage) the stage with m blocks of group g reads
// [G (D - 2m) + g m, G (D - 2m) + (g + 1) m).
template <typename W, int S, int LOG_D, bool FINAL>
__global__ void __launch_bounds__(CROSS_THREADS)
    cross_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ irop_cross,
                     const u64* __restrict__ pirop_cross, u64 q64,
                     InvFinal<W> fin, int omf, int log_lc, int log_groups,
                     long long columns) {
  constexpr int D = 1 << LOG_D;
  // The final form has one group, so its table offsets stay constants of
  // the program (run-time ones cost the D = 64 u64 inverse a spill).
  const int groups = FINAL ? 1 : 1 << log_groups;
  W *tw, *twp;
  stage_twiddles(tw, twp, irop_cross, pirop_cross,
                 FINAL ? D - 2 : (D - 1) * groups, D * groups);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= columns) return;
  const int group = FINAL ? 0 : (int)((g >> log_lc) & (groups - 1));
  const long long base = column_base(g, LOG_D, log_lc);
  const W q = (W)q64;
  const W two_q = 2 * q;
  W v[D];
  load_column(v, x, base, log_lc);
  static_for<0, LOG_D - 1>([&](auto s) {
    constexpr int half = 1 << decltype(s)::value;
    constexpr int m = D / (2 * half);
    const int first = (D - 2 * m) * groups + group * m;
    static_for<0, m>([&](auto k) {
      constexpr int at = 2 * half * decltype(k)::value;
      static_for<0, half>([&](auto i) {
        inv_butterfly<W, S>(v[at + i], v[at + i + half], tw[first + k],
                            twp[first + k], q, two_q);
      });
    });
  });
  if constexpr (FINAL) {
    // The global final stage (stride N/2) fused with N^-1, then the OMF.
    static_for<0, D / 2>([&](auto i) {
      inv_final_butterfly<W, S>(v[i], v[i + D / 2], fin, q, two_q);
    });
    if (omf == 1) {
      static_for<0, D>([&](auto d) { v[d] = halve(v[d], q); });
    }
  } else {
    const int last = (D - 2) * groups + group;
    static_for<0, D / 2>([&](auto i) {
      inv_butterfly<W, S>(v[i], v[i + D / 2], tw[last], twp[last], q, two_q);
    });
  }
  store_column(v, y, base, log_lc);
}

// CTAs for `columns` threads, or 0 when the grid would not fit an int.
static int cross_grid(long long columns) {
  const long long grid = (columns + CROSS_THREADS - 1) / CROSS_THREADS;
  return grid > 0x7fffffffLL ? 0 : (int)grid;
}

// The shared memory of twiddle tables of 2^log_table entries each.
template <typename W>
static size_t cross_smem(int log_table) {
  return (size_t)2 * sizeof(W) << log_table;
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
// is a Scheme code (modarith.cuh), a lean one with word 64 only.
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
  if (scheme == LEAN16)
    return cross_fwd_at<u64, LEAN16, 1>(log_d, x, y, rop, prop, q, log_lc,
                                        log_groups, columns, stream);
  if (scheme == LEAN8)
    return cross_fwd_at<u64, LEAN8, 1>(log_d, x, y, rop, prop, q, log_lc,
                                       log_groups, columns, stream);
  if (scheme != EXACT) return (int)cudaErrorInvalidValue;
  return cross_fwd_at<u64, EXACT, 1>(log_d, x, y, rop, prop, q, log_lc,
                                     log_groups, columns, stream);
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
  if (scheme == LEAN16)
    return cross_inv_at<u64, LEAN16, 1>(log_d, x, y, irop_cross, pirop_cross,
                                        q, fin, omf, final_stage, log_lc,
                                        log_groups, columns, stream);
  if (scheme == LEAN8)
    return cross_inv_at<u64, LEAN8, 1>(log_d, x, y, irop_cross, pirop_cross,
                                       q, fin, omf, final_stage, log_lc,
                                       log_groups, columns, stream);
  if (scheme != EXACT) return (int)cudaErrorInvalidValue;
  return cross_inv_at<u64, EXACT, 1>(log_d, x, y, irop_cross, pirop_cross, q,
                                     fin, omf, final_stage, log_lc,
                                     log_groups, columns, stream);
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
  if (scheme == LEAN16)
    return cross_tile_fwd_at<u64, LEAN16, 1>(
        log_d, x, y, rop, prop, q, log_lc, log_groups, batch, stream);
  if (scheme == LEAN8)
    return cross_tile_fwd_at<u64, LEAN8, 1>(
        log_d, x, y, rop, prop, q, log_lc, log_groups, batch, stream);
  if (scheme != EXACT) return (int)cudaErrorInvalidValue;
  return cross_tile_fwd_at<u64, EXACT, 1>(
      log_d, x, y, rop, prop, q, log_lc, log_groups, batch, stream);
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
  if (scheme == LEAN16)
    return cross_tile_inv_at<u64, LEAN16, 1>(
        log_d, x, y, irop_cross, pirop_cross, q, fin, omf, final_stage,
        log_lc, log_groups, batch, stream);
  if (scheme == LEAN8)
    return cross_tile_inv_at<u64, LEAN8, 1>(
        log_d, x, y, irop_cross, pirop_cross, q, fin, omf, final_stage,
        log_lc, log_groups, batch, stream);
  if (scheme != EXACT) return (int)cudaErrorInvalidValue;
  return cross_tile_inv_at<u64, EXACT, 1>(
      log_d, x, y, irop_cross, pirop_cross, q, fin, omf, final_stage, log_lc,
      log_groups, batch, stream);
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
