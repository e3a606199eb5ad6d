// K1.rns.cl, K6.rns.cl and K6.shard.cl: the stacked transform of
// ntt_rns.cu with a cluster of C = 2^LOG_C CTAs (2 to 16) for each
// transform of 2^log_n (K1.rns.cl, 2^12 .. 2^14), 2^14 shard of the split
// (K6.rns.cl, the local pass above 2^14) or shard of 2^12 .. 2^14 of a
// DistNTT position (K6.shard.cl: its local pass, or above 2^14 that of its
// 2^14 sub-shards, with K6's shard base and period), joined through
// distributed shared memory.
//
// Replaces, where a launch's one-CTA grid is under a wave, the same TPU
// kernels as K1.rns and K6.rns (ntt_rns.cu): hexl_tpu/ntt/pallas_ntt.py::
// _run and hexl_tpu/ntt/hier.py::_local_call, vmapped over the prime axis
// by hexl_tpu/ntt/rns.py; and those of K6 with a shard base
// (ntt_hier.cu), hexl_tpu/parallel/dist_ntt.py::DistNTT._pallas_local.
//
// What bounds the one-CTA form there: a CTA's walk of 2^14 is about
// 0.030 ms whether the launch has 2 CTAs or 28 (PERF.md), and
// the key switch's transforms launch 2-56 of them on 132 SMs. Here the
// transform of 2^n is the (C, 2^n / C) view: its first c = LOG_C forward
// stages (strides 2^n / 2 .. 2^n / C) pair the C values of a column, the
// rest stay within a row. CTA r of the cluster
//   - arrives at a cluster barrier (so that no CTA writes into a peer that
//     has not started), loads its 2^n / C^2 columns from global memory and
//     runs the first c stages on each in registers (the column form's
//     body, cross_col.cuh column_fwd_stages);
//   - waits at the barrier, then writes row i of its columns into CTA i's
//     shared memory (cluster.map_shared_rank) at the radix slots of their
//     positions in chunk i; a cluster barrier;
//   - runs the other n - c stages on its chunk (row r, 2^n / C
//     contiguous coefficients) with the radix walk of ntt_block.cuh,
//     starting from shared memory (FROM_SM), as sub-shard r of C of the
//     transform (twiddle base C + r), or of the shard (base 2^(log_d + c)
//     + C shard + r), and stores it coalesced.
// The inverse mirrors it: the walk's stages of stride < 2^n / C on the
// CTA's chunk, its last pass stored back to its slots; a cluster barrier;
// each CTA pulls its columns from the peers' shared memory, arrives at a
// cluster barrier (done reading), runs the c cross stages on them
// (column_inv_stages), the last one fused with N^-1 and the OMF for a
// whole transform (K1.rns.cl) or an ordinary stage for a shard
// (K6.rns.cl, whose global final stage K5.rns runs), stores them, and
// waits at that barrier before it leaves. Every stage keeps the flat
// walk's butterflies and twiddles (each row's own tables through its
// RnsRow), so every output, lazy ones included, is bit-identical to the
// one-CTA form. The exact scheme only; the lean ones keep C = 1.
//
// A CTA holds 2^n / C coefficients (8 2^n / C bytes) on 2^n / 8C threads,
// a group of 8 a thread, and its columns take 8 / C a thread (C <= 8), or
// two threads a column (C = 16: a shuffle between the first stage and the
// other three, so that no thread runs a column of 16 alone). What the
// card showed (PERF.md): against one CTA, 1.2-4.2x faster under a wave;
// a launch still costs its floor, one exposed cluster barrier a direction
// and a walk on few threads a SM. Variants timed against this form: the
// hand-off through global memory (L2) under the same barriers (slower at
// 2^12-2^13, 0.97-0.98x at 2^14 with C = 16), the inverse's hand-off
// pushed instead of pulled with C = 16 on one thread a column (slower at
// 2^12-2^13), a CTA an SM forced by its shared memory (no change). A
// DistNTT position's shard is the same walk at another twiddle base: on
// an H100 at 700 W a 2^14 shard of the sharded RNS product took 0.0069-
// 0.0072 ms a launch at C = 16 against one CTA's 0.030, and the key
// switch's 2^12 shards 0.0058-0.0064 at C = 4 against 0.0082-0.0085.
#pragma once

#include <cooperative_groups.h>

#include "cross_col.cuh"
#include "ntt_block.cuh"
#include "rns.cuh"

namespace cg = cooperative_groups;

// A table in global memory read through the read-only cache, indexed as
// column_fwd_stages and column_inv_stages index theirs.
struct LdgTable {
  const u64* p;
  __device__ __forceinline__ u64 operator[](int i) const {
    return __ldg(p + i);
  }
};

// The halves of a cluster barrier (cluster.sync() is both): arrive
// releases this thread's writes, wait acquires the cluster's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Where a cluster's CTA works: row blockIdx.y, chunk t = blockIdx.x >>
// LOG_C of the row, shard `shard` = shard_base + (t mod 2^log_sub) of the
// 2^log_d of its transform (as K6's CTA b runs shard shard_base + (b mod
// 2^log_sub): the split passes (0, log_d), a DistNTT position its own
// shard or first sub-shard), CTA `rank`, `off` the chunk's first
// coefficient.
template <int LOG_C>
struct ClusterPlace {
  int rank, shard;
  long long off;
  __device__ __forceinline__ ClusterPlace(int log_n, int shard_base,
                                          int log_sub) {
    const long long t = blockIdx.x >> LOG_C;
    rank = (int)cg::this_cluster().block_rank();
    shard = shard_base + (int)(t & ((1 << log_sub) - 1));
    off = ((long long)blockIdx.y * (gridDim.x >> LOG_C) + t) << log_n;
  }
};

// The CTA's threads, 2^log_chunk / 8, as a bound for the compiler: LOGN
// is log_chunk when a constant of the instantiation (from 2^10 up), else 0
// (chunks of 2^8 and 2^9).
template <int LOGN>
__host__ __device__ constexpr int cluster_threads() {
  return LOGN ? 1 << (LOGN - 3) : 64;
}

// The forward of one transform (log_d = 0) or shard of 2^log_n of a
// transform of 2^(log_n + log_d) (ClusterPlace's), a chunk of 2^log_chunk
// (log_n = log_chunk + LOG_C) a CTA.
template <int LOG_C, int LOGN>
__global__ void __launch_bounds__(cluster_threads<LOGN>())
    rns_cluster_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                           const RnsRow* __restrict__ rows,
                           int log_chunk_arg, int omf, int log_d,
                           int shard_base, int log_sub) {
  constexpr int C = 1 << LOG_C, LOGR = 3, COLS = C <= 8 ? 8 / C : 1;
  const int log_chunk = LOGN ? LOGN : log_chunk_arg;
  const int log_cols = log_chunk - LOG_C, cols = 1 << log_cols;
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  u64* sm = reinterpret_cast<u64*>(ntt_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPlace<LOG_C> at(log_chunk + LOG_C, shard_base, log_sub);
  const RnsRow& row = rows[blockIdx.y];
  const u64 q = row.q, two_q = 2 * q;
  cluster_arrive();
  const int base_m = (1 << log_d) + at.shard;
  if constexpr (C == 16) {
    // Two threads a column (cols = blockDim.x / 2): thread h runs the
    // first stage on rows 4h + i and 8 + 4h + i (i < 4), trades four
    // values with its partner for rows 8h .. 8h + 7, and runs the other
    // three stages on those, their twiddles at 2 base_m + h as a column
    // of 8 (column_fwd_stages).
    const int j = threadIdx.x >> 1, h = threadIdx.x & 1;
    const u64* col = x + at.off + (at.rank << log_cols) + j;
    u64 a[4], b[4], v[8];
    static_for<0, 4>([&](auto i) {
      a[i] = __ldg(col + ((long long)(4 * h + i) << log_chunk));
      b[i] = __ldg(col + ((long long)(8 + 4 * h + i) << log_chunk));
    });
    const u64 w = __ldg(row.rop + base_m), wp = __ldg(row.prop + base_m);
    static_for<0, 4>([&](auto i) {
      fwd_butterfly<u64, EXACT>(a[i], b[i], w, wp, q, two_q);
      const u64 got = __shfl_xor_sync(0xffffffffu, h ? a[i] : b[i], 1);
      v[i] = h ? got : a[i];
      v[4 + i] = h ? b[i] : got;
    });
    column_fwd_stages<u64, EXACT, 3>(v, LdgTable{row.rop}, LdgTable{row.prop},
                                     2 * base_m + h, q, two_q);
    cluster_wait();
    const int slot = radix_slot<LOGR>((at.rank << log_cols) + j);
    static_for<0, 8>([&](auto i) {
      cluster.map_shared_rank(sm, 8 * h + (int)decltype(i)::value)[slot] =
          v[i];
    });
  } else {
    // Columns j = threadIdx.x + h blockDim.x (cols = COLS blockDim.x),
    // one at a time (at 1024 threads two columns held at once spill);
    // every thread waits once, after its first.
    static_for<0, COLS>([&](auto h) {
      const int j = threadIdx.x + decltype(h)::value * blockDim.x;
      const u64* col = x + at.off + (at.rank << log_cols) + j;
      u64 v[C];
      static_for<0, C>([&](auto i) {
        v[i] = __ldg(col + ((long long)decltype(i)::value << log_chunk));
      });
      column_fwd_stages<u64, EXACT, LOG_C>(v, LdgTable{row.rop},
                                           LdgTable{row.prop}, base_m, q,
                                           two_q);
      if constexpr (decltype(h)::value == 0) cluster_wait();
      const int slot = radix_slot<LOGR>((at.rank << log_cols) + j);
      static_for<0, C>([&](auto i) {
        cluster.map_shared_rank(sm, (int)decltype(i)::value)[slot] = v[i];
      });
    });
  }
  cluster.sync();
  radix_fwd_passes<u64, EXACT, LOGR, 1, LOGN, false, true>(
      sm, [&](int) { return x; }, log_chunk, 1, 0,
      (1 << (log_d + LOG_C)) + (at.shard << LOG_C) + at.rank, row.rop,
      row.prop, q, omf);
  radix_fwd_store<u64, LOGR, 1, false>(
      sm, [&](int) { return y + at.off + ((long long)at.rank << log_chunk); },
      log_chunk, 1);
}

// The inverse: FINAL for a whole transform (K1.rns.cl), not for a shard
// (K6.rns.cl, K6.shard.cl), which stops before the global final stage.
template <int LOG_C, int LOGN, bool FINAL>
__global__ void __launch_bounds__(cluster_threads<LOGN>())
    rns_cluster_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                           const RnsRow* __restrict__ rows,
                           int log_chunk_arg, int omf, int log_d,
                           int shard_base, int log_sub) {
  constexpr int C = 1 << LOG_C, LOGR = 3, COLS = C <= 8 ? 8 / C : 1;
  const int log_chunk = LOGN ? LOGN : log_chunk_arg;
  const int log_cols = log_chunk - LOG_C, cols = 1 << log_cols;
  const int log_big_n = log_chunk + LOG_C + log_d;
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  u64* sm = reinterpret_cast<u64*>(ntt_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPlace<LOG_C> at(log_chunk + LOG_C, shard_base, log_sub);
  const RnsRow& row = rows[blockIdx.y];
  const u64 q = row.q, two_q = 2 * q;
  const InvFinal<u64> fin = row_final(row);
  const long long skip = 1 + (1LL << log_big_n);
  const u64* src = x + at.off + ((long long)at.rank << log_chunk);
  // The walk, its last pass stored back to the slots it read.
  radix_inv_passes<u64, EXACT, LOGR, 1, LOGN, false, false>(
      sm,
      [&](auto& v, int, int u) {
        radix_load_row<u64, LOGR>(v, src + ((long long)u << LOGR));
      },
      [&](auto& v, int, int u, int s) { radix_put<u64, LOGR>(sm, v, u, s); },
      log_chunk, log_big_n, (at.shard << LOG_C) + at.rank, 1, 0,
      row.irop + skip, row.pirop + skip, q, fin, omf);
  cluster.sync();
  // Row i of column J (this CTA's J = rank cols + j) is position J of
  // chunk i, in CTA i's shared memory at the slot of J. The cross stages
  // from the stage of stride 2^log_chunk: entry 1 + N - C 2^log_d of the
  // stage-major table on (torch_ntt.root_index); G groups (the shards of
  // the split), this shard's group g.
  const long long cross = skip - ((long long)C << log_d);
  const LdgTable tw{row.irop + cross}, twp{row.pirop + cross};
  const int groups = FINAL ? 1 : 1 << log_d, group = FINAL ? 0 : at.shard;
  if constexpr (C == 16) {
    // Two threads a column, as the forward's: thread h runs the first
    // three stages on rows 8h .. 8h + 7 (a column of 8 in groups of 2G,
    // its group 2g + h), trades four values with its partner, and runs
    // the last stage on rows 4h + i and 8 + 4h + i (i < 4).
    const int j = threadIdx.x >> 1, h = threadIdx.x & 1;
    const int slot = radix_slot<LOGR>((at.rank << log_cols) + j);
    u64 v[8], a[4], b[4];
    static_for<0, 8>([&](auto i) {
      v[i] = cluster.map_shared_rank(sm, 8 * h + (int)decltype(i)::value)
          [slot];
    });
    cluster_arrive();
    column_inv_stages<u64, EXACT, 3, false>(v, tw, twp, 2 * groups,
                                            2 * group + h, fin, omf, q,
                                            two_q);
    static_for<0, 4>([&](auto i) {
      const u64 got = __shfl_xor_sync(0xffffffffu, h ? v[i] : v[4 + i], 1);
      a[i] = h ? got : v[i];
      b[i] = h ? v[4 + i] : got;
    });
    const int last = 14 * groups + group;
    const u64 w = tw[last], wp = twp[last];
    u64* col = y + at.off + (at.rank << log_cols) + j;
    static_for<0, 4>([&](auto i) {
      if constexpr (FINAL) {
        inv_final_butterfly<u64, EXACT>(a[i], b[i], fin, q, two_q);
        if (omf == 1) {
          a[i] = halve(a[i], q);
          b[i] = halve(b[i], q);
        }
      } else {
        inv_butterfly<u64, EXACT>(a[i], b[i], w, wp, q, two_q);
      }
      col[(long long)(4 * h + i) << log_chunk] = a[i];
      col[(long long)(8 + 4 * h + i) << log_chunk] = b[i];
    });
  } else {
    // Columns j = threadIdx.x + h blockDim.x, as the forward's.
    static_for<0, COLS>([&](auto h) {
      const int j = threadIdx.x + decltype(h)::value * blockDim.x;
      const int slot = radix_slot<LOGR>((at.rank << log_cols) + j);
      u64 v[C];
      static_for<0, C>([&](auto i) {
        v[i] = cluster.map_shared_rank(sm, (int)decltype(i)::value)[slot];
      });
      // Done reading the peers' shared memory after the last column.
      if constexpr (decltype(h)::value == COLS - 1) cluster_arrive();
      column_inv_stages<u64, EXACT, LOG_C, FINAL>(v, tw, twp, groups, group,
                                                  fin, omf, q, two_q);
      u64* col = y + at.off + (at.rank << log_cols) + j;
      static_for<0, C>([&](auto i) {
        col[(long long)decltype(i)::value << log_chunk] = v[i];
      });
    });
  }
  // No CTA leaves while a peer may still read its shared memory.
  cluster_wait();
}
