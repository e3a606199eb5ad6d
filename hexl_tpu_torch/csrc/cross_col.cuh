// K5's column form: the cross pass of ntt_hier.cu with a thread a column,
// as device functions that a kernel calls on its CTA's columns. The
// single-modulus kernels (ntt_hier.cu cross_fwd_kernel, cross_inv_kernel)
// pass their arguments; the stacked ones (cross_rns.cu) a row's block,
// modulus and tables. ntt_hier.cu's source note says what the form
// computes and what bounds it.
#pragma once

#include "modarith.cuh"
#include "radix.cuh"

constexpr int CROSS_THREADS = 128;

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

// The stages of one column of D = 2^LOG_D values in registers, v[d] the
// value of row d (rows at the transform's stride), with the twiddles of
// tw[i], twp[i] (a table in shared memory here, in global memory for the
// cluster form's columns, ntt_cluster.cuh). Forward: the stage with m
// blocks pairs rows 2 half k + i and 2 half k + i + half (half = D / 2m)
// at twiddle m base_m + k.
template <typename W, int S, int LOG_D, typename Table>
__device__ __forceinline__ void column_fwd_stages(W (&v)[1 << LOG_D],
                                                  const Table& tw,
                                                  const Table& twp,
                                                  int base_m, W q, W two_q) {
  constexpr int D = 1 << LOG_D;
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
}

// Inverse: the stage with m blocks of group `group` of `groups` at
// twiddles (D - 2m) groups + group m + k; with FINAL the last stage (m =
// 1) is the global final stage fused with N^-1, then the OMF; without it,
// an ordinary stage at (D - 2) groups + group.
template <typename W, int S, int LOG_D, bool FINAL, typename Table>
__device__ __forceinline__ void column_inv_stages(
    W (&v)[1 << LOG_D], const Table& tw, const Table& twp, int groups,
    int group, const InvFinal<W>& fin, int omf, W q, W two_q) {
  constexpr int D = 1 << LOG_D;
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
}

// x, y: (batch, D, lc) with D = 2^LOG_D; thread g of `columns` =
// batch * lc (g = blockIdx.x * blockDim.x + threadIdx.x) owns column g.
// Block b of the batch is group b mod G (G = 2^log_groups; G = 1 but where
// the rows of G consecutive blocks are one block of G D rows, see
// hexl_cross_fwd): the stage with m blocks reads rop/prop[m (G + group) +
// k] for block k, and the tables hold D G entries.
template <typename W, int S, int LOG_D>
__device__ __forceinline__ void cross_fwd_columns(
    const u64* __restrict__ x, u64* __restrict__ y,
    const u64* __restrict__ rop, const u64* __restrict__ prop, u64 q64,
    int log_lc, int log_groups, long long columns) {
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
  column_fwd_stages<W, S, LOG_D>(v, tw, twp, base_m, q, two_q);
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
__device__ __forceinline__ void cross_inv_columns(
    const u64* __restrict__ x, u64* __restrict__ y,
    const u64* __restrict__ irop_cross, const u64* __restrict__ pirop_cross,
    u64 q64, const InvFinal<W>& fin, int omf, int log_lc, int log_groups,
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
  column_inv_stages<W, S, LOG_D, FINAL>(v, tw, twp, groups, group, fin, omf,
                                        q, two_q);
  store_column(v, y, base, log_lc);
}

// CTAs for `columns` threads, or 0 when the grid would not fit an int.
static inline int cross_grid(long long columns) {
  const long long grid = (columns + CROSS_THREADS - 1) / CROSS_THREADS;
  return grid > 0x7fffffffLL ? 0 : (int)grid;
}

// The shared memory of twiddle tables of 2^log_table entries each.
template <typename W>
static size_t cross_smem(int log_table) {
  return (size_t)2 * sizeof(W) << log_table;
}
