// The NTT walk that runs inside one CTA, and the kernels built on it.
//
// The stage order, twiddle indexing and butterflies are those of the flat
// exact-Harvey walk (hexl_tpu/ntt/jnp_ntt.py fwd_body_small/inv_body_small,
// and hexl_tpu_torch/ntt/torch_ntt.py): the forward stage with m blocks of
// stride t = n/(2m) reads rop[m + k] for block k; the inverse walks the
// stage-major irop table from index 1 upward by ascending stride.
//
// A CTA holds whole transforms of n = 2^log_n (log_d = 0), or shard
// `shard` of the 2^log_d contiguous shards of one transform of degree
// 2^(log_n + log_d) (the local pass K6: of the two-pass split,
// hexl_tpu_torch/ntt/hier.py, and of one position of the coefficient-
// sharded transform, hexl_tpu_torch/parallel/dist_ntt.py; and the half of
// the product that each CTA of K3's cluster inverts, poly.cu). A shard runs
// the global stages of stride t < n in place, with its twiddles read from
// the flat tables at its offset: forward block k of the stage with m
// blocks per shard reads rop[m * (2^log_d + shard) + k]; inverse block k
// at stride t reads irop[root_index(t) + shard * n/(2t) + k]. With
// log_d = 0 these are the flat walk's indices. The inverse of a shard
// stops before the global final stage, which the cross pass K5 runs.
// The CTAs of a launch hold consecutive chunks of x; the shard of CTA b
// is shard_base + (b mod 2^log_sub): the two-pass split passes
// (0, log_d), every shard of each polynomial in turn; a position of the
// sharded transform passes its own shard (log_sub = 0), or its first
// 2^14-coefficient sub-shard and their count when it holds more.
//
// The radix walk (radix_fwd_passes/radix_inv_passes) runs every NTT kernel
// of one CTA: K1 (one 64-bit polynomial per CTA), K2 (P > 1 of them), K7
// (one single-word polynomial, up to 2^15), K6 (one shard, both words) and
// K3's transforms (poly.cu). The transform is cut into n/R groups of
// R = 2^LOGR coefficients (R = 8 from n = 8 on, 2 below); a thread takes G
// of them (with_shape: 1024 threads from 2^13 on, G = 2 at 2^14, 4 at
// 2^15; else one group a thread) and holds a group's R coefficients in
// registers while it runs up to LOGR consecutive stages on them, a radix
// pass, with no barrier and no shared-memory access; radix.cuh has the
// pass layout, the swizzle and the twiddle bases, which the FFT-like's K12
// shares. Each stage of a pass reads its 2^(LOGR-1-j) twiddle pairs once.
// Between passes the transform rests in shared memory: a group is loaded
// in the next pass's layout and stored back to the same slots, so one
// barrier ends a pass, and the swizzle (radix_slot) keeps every access of
// every pass free of bank conflicts. There is no fill phase: the forward's
// first pass loads from global memory (group u reads x[u + i n/R],
// coalesced), the inverse's a row of R consecutive words; the inverse's
// last pass stores (coalesced, through the final stage fused with N^-1 and
// the OMF reduction for a whole transform, as it stands for a shard), the
// forward's last pass ends with the lean fixup and the OMF reduction, and
// one more barrier turns its groups back into the coalesced layout for the
// store. At 2^14 that is 5 passes and 4 barriers (the forward 5), where a
// walk of one stage at a time makes 14 shared-memory round trips and 15
// barriers. Inside a stage only the order of the butterflies differs from
// the flat walk, so every output, lazy ones included, is bit-identical to
// it. The loads and stores at the ends of the walk are the caller's
// (functors), so that K3 can form its product in the inverse's first load
// and keep its transforms in shared memory.
//
// K2 packs P transforms into a CTA (PACKED, P a power of two): its P n/R
// groups are one virtual transform of P n coefficients for the slots, so
// that virtual group U = p n/R + u of transform p lies at the slots K1's
// group U of a P n transform would (radix_base(U, s) = p n +
// radix_base(u, s)), every pass free of bank conflicts, while the
// twiddles and global addresses follow u and p. Where a transform's n/R
// groups lie within one warp (n/R <= 32), only that warp reads what it
// wrote, and __syncwarp ends a pass instead of the CTA's barrier; a
// ragged last CTA skips the groups of the transforms it lacks.
//
// What bounds it on an H100: at 2^14 u64 a transform is 128 KB, so one
// CTA fits an SM (registers and shared memory both), and 1024 threads
// leave 64 registers a thread. A 64-bit Harvey butterfly is about 50
// instructions (16 IMADs of the Shoup product, the rest 64-bit adds,
// compares and selects, per the SASS), so the walk is bound by issue, not
// by the IMAD pipe alone, with the HBM load of a wave's first pass and
// the store of its last exposed (one CTA a SM leaves nothing to overlap
// them with). R = 16 a thread (4 stages a pass) spills at 64 registers
// whatever the order of the twiddle loads; R = 8 in two groups does not,
// and runs faster. In u32 a 2^14 transform is 64 KB, and a u32 butterfly
// (one 32-bit high product, two low ones) far fewer instructions: K7 and
// the u32 K6 are bound by bytes. log_n is a constant of the instantiation
// from 2^10 up, where the pass schedule then unrolls at compile time.
// Small transforms (K2) are bound by bytes: a pass there is a few
// butterflies a thread, and packing buys a CTA of more than a few
// threads, not fewer barriers.
//
// W is the word the coefficients occupy on chip: u64, or u32 for
// q < 2^30, where every lazy value is < 4q < 2^32 (the single-word regime
// of hexl_tpu/ntt/ntt32.py). Global memory always holds int64 tensors of
// u64 bits; a u32 walk narrows on the load and widens on the store. S is
// the butterfly scheme (modarith.cuh): a lean forward ends with its fixup
// before the OMF reduction, a lean inverse with its own final stage.
#pragma once

#include "modarith.cuh"
#include "radix.cuh"

// The R consecutive words row[0 .. R) in 16-byte loads where row is
// aligned (it is at every offset the wrappers give, but a tensor's storage
// offset may not be), narrowed to W: the inverse's first pass.
template <typename W, int LOGR>
__device__ __forceinline__ void radix_load_row(W (&v)[1 << LOGR],
                                               const u64* __restrict__ row) {
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const ulonglong2* r2 = reinterpret_cast<const ulonglong2*>(row);
    static_for<0, (1 << LOGR) / 2>([&](auto i) {
      const ulonglong2 p = __ldg(r2 + i);
      v[2 * i] = (W)p.x;
      v[2 * i + 1] = (W)p.y;
    });
  } else {
    static_for<0, (1 << LOGR)>([&](auto i) { v[i] = (W)__ldg(row + i); });
  }
}

// The stages of one pass. In the pass with register bits at s, the
// stage of register bit j (stride 2^(s + j)) gives each thread
// C = 2^(LOGR-1-j) butterfly blocks, consecutive from tb C (tb = t >> s),
// each of 2^j butterflies (i, i + 2^j). Its twiddles start at g >> j, g
// formed once a pass (radix_fwd_g, radix_inv_g): every term of the flat
// index is a multiple of 2^j there, so one shift gives it.

// Forward, j = top - 1 down to 0: block k of the stage with m blocks per
// shard at rop[m (2^log_d + shard) + k].
template <typename W, int S, int LOGR>
__device__ __forceinline__ void radix_fwd_pass(
    W (&v)[1 << LOGR], int top, int g, const u64* __restrict__ rop,
    const u64* __restrict__ prop, W q, W two_q) {
  static_for<0, LOGR>([&](auto jj) {
    constexpr int J = LOGR - 1 - decltype(jj)::value;
    if (J < top) {
      const int at = g >> J;
      static_for<0, (1 << (LOGR - 1 - J))>([&](auto c) {
        const W w = (W)__ldg(rop + at + c), wp = (W)__ldg(prop + at + c);
        static_for<0, (1 << J)>([&](auto k) {
          constexpr int I = (decltype(c)::value << (J + 1)) + decltype(k)::value;
          fwd_butterfly<W, S>(v[I], v[I + (1 << J)], w, wp, q, two_q);
        });
      });
    }
  });
}

// Inverse, j in [lo, hi) ascending: block k at stride 2^b (b = s + j) at
// irop[1 + N - N/2^b + shard n/2^(b+1) + k] (N = n 2^log_d); irop1 and
// pirop1 point at the tables' entry 1 + N, g (negative) is the rest.
template <typename W, int S, int LOGR>
__device__ __forceinline__ void radix_inv_pass(
    W (&v)[1 << LOGR], int lo, int hi, int g, const u64* __restrict__ irop1,
    const u64* __restrict__ pirop1, W q, W two_q) {
  static_for<0, LOGR>([&](auto jj) {
    constexpr int J = decltype(jj)::value;
    if (J >= lo && J < hi) {
      const int at = g >> J;
      static_for<0, (1 << (LOGR - 1 - J))>([&](auto c) {
        const W w = (W)__ldg(irop1 + at + c), wp = (W)__ldg(pirop1 + at + c);
        static_for<0, (1 << J)>([&](auto k) {
          constexpr int I = (decltype(c)::value << (J + 1)) + decltype(k)::value;
          inv_butterfly<W, S>(v[I], v[I + (1 << J)], w, wp, q, two_q);
        });
      });
    }
  });
}

// Group h of this thread: U = t + h T, over the P n/R groups of the CTA's
// transforms (one unless PACKED). Returns U; u is its group within
// transform p = U >> log_groups (log_groups = log_n - LOGR).
template <bool PACKED>
__device__ __forceinline__ int radix_group(int h, int log_groups, int& u,
                                           int& p) {
  const int U = threadIdx.x + h * blockDim.x;
  u = PACKED ? U & ((1 << log_groups) - 1) : U;
  p = PACKED ? U >> log_groups : 0;
  return U;
}

// The barrier ending a pass: the CTA's, or (warp_mask != 0, PACKED) that
// of the warp's lanes in warp_mask.
__device__ __forceinline__ void radix_sync(unsigned warp_mask) {
  if (warp_mask)
    __syncwarp(warp_mask);
  else
    __syncthreads();
}

// The warp barrier's lanes where each of the CTA's transforms lies within
// one warp (2^log_groups <= 32 groups a transform, one a thread), else 0.
__device__ __forceinline__ unsigned packed_warp_mask(int log_groups) {
  if (log_groups > 5) return 0;
  return blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1;
}

// The forward passes of the CTA's transforms into shared memory, each pass
// from the top stride down: pass p runs the stages of strides 2^s ..
// 2^(hi - 1), hi = log_n - p LOGR, s = max(hi - LOGR, 0). The first loads
// group u of transform p from global memory (u reads src(p)[u + i n/R]),
// the last ends with the lean fixup and the OMF reduction; each pass ends
// with a barrier. `polys` transforms are present (PACKED; else one), the
// first blocks of their stages at first_block (2^log_d + shard). LOGN,
// when not 0, is log_n as a constant of the instantiation (the pass
// schedule then unrolls at compile time). FROM_SM: the transform already
// rests in shared memory at the slots of its positions (the cluster
// form's hand-off, ntt_cluster.cuh), and the first pass reads it there.
template <typename W, int S, int LOGR, int G, int LOGN, bool PACKED,
          bool FROM_SM = false, typename Src>
__device__ __forceinline__ void radix_fwd_passes(
    W* sm, Src&& src, int log_n_arg, int polys, unsigned warp_mask,
    int first_block, const u64* __restrict__ rop,
    const u64* __restrict__ prop, W q, int omf) {
  constexpr int R = 1 << LOGR;
  const int log_n = LOGN ? LOGN : log_n_arg;
  const W two_q = 2 * q;
  const int passes = (log_n + LOGR - 1) / LOGR;
#pragma unroll
  for (int p = 0; p < passes; ++p) {
    const int hi = log_n - p * LOGR, s = max(hi - LOGR, 0);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      int u, poly;
      const int U = radix_group<PACKED>(h, log_n - LOGR, u, poly);
      if (PACKED && poly >= polys) continue;
      W v[R];
      if (p == 0 && !FROM_SM) {
        const u64* x = src(poly);
        static_for<0, R>([&](auto i) {
          v[i] = (W)__ldg(x + u + (decltype(i)::value << s));
        });
      } else {
        radix_get<W, LOGR>(sm, v, U, s);
      }
      radix_fwd_pass<W, S, LOGR>(v, hi - s,
                                 radix_fwd_g(first_block, log_n, s, u, LOGR),
                                 rop, prop, q, two_q);
      if (p == passes - 1) {
        static_for<0, R>([&](auto i) {
          const W r = fwd_fixup<W, S>(v[i], q);
          v[i] = omf == 1 ? reduce_lazy<W>(r, q, 4) : r;
        });
      }
      radix_put<W, LOGR>(sm, v, U, s);
    }
    radix_sync(warp_mask);
  }
}

// After the forward passes: each group read back in the first pass's
// layout and stored, coalesced (u writes dst(p)[u + i n/R]).
template <typename W, int LOGR, int G, bool PACKED, typename Dst>
__device__ __forceinline__ void radix_fwd_store(const W* sm, Dst&& dst,
                                                int log_n, int polys) {
#pragma unroll 1
  for (int h = 0; h < G; ++h) {
    int u, poly;
    const int U = radix_group<PACKED>(h, log_n - LOGR, u, poly);
    if (PACKED && poly >= polys) continue;
    W v[1 << LOGR];
    radix_get<W, LOGR>(sm, v, U, log_n - LOGR);
    u64* y = dst(poly);
    static_for<0, (1 << LOGR)>([&](auto i) {
      y[u + (decltype(i)::value << (log_n - LOGR))] = v[i];
    });
  }
}

// The inverse passes from the bottom stride up: pass p runs the stages of
// strides 2^lo .. 2^(hi - 1), lo = p LOGR, hi = min(lo + LOGR, log_n), on
// register bits at s = min(lo, log_n - LOGR). The first pass's groups,
// rows of R consecutive coefficients, come from load(v, p, u); the last
// pass's go to store(v, p, u, s). FINAL (a whole transform): the last
// pass's top stage is the final stage fused with N^-1 and the OMF
// reduction; a shard of the transform of 2^log_big_n has none.
template <typename W, int S, int LOGR, int G, int LOGN, bool FINAL,
          bool PACKED, typename Load, typename Store>
__device__ __forceinline__ void radix_inv_passes(
    W* sm, Load&& load, Store&& store, int log_n_arg, int log_big_n,
    int shard, int polys, unsigned warp_mask, const u64* __restrict__ irop1,
    const u64* __restrict__ pirop1, W q, const InvFinal<W>& fin, int omf) {
  constexpr int R = 1 << LOGR;
  const int log_n = LOGN ? LOGN : log_n_arg;
  const W two_q = 2 * q;
  const int passes = (log_n + LOGR - 1) / LOGR;
#pragma unroll
  for (int p = 0; p < passes; ++p) {
    const int lo = p * LOGR, hi = min(lo + LOGR, log_n);
    const int s = min(lo, log_n - LOGR);
    const bool last = p == passes - 1;
#pragma unroll
    for (int h = 0; h < G; ++h) {
      int u, poly;
      const int U = radix_group<PACKED>(h, log_n - LOGR, u, poly);
      if (PACKED && poly >= polys) continue;
      W v[R];
      if (p == 0) {
        load(v, poly, u);
      } else {
        radix_get<W, LOGR>(sm, v, U, s);
      }
      radix_inv_pass<W, S, LOGR>(
          v, lo - s, hi - s - (FINAL && last),
          radix_inv_g(shard, log_n, log_big_n, s, u, LOGR), irop1, pirop1,
          q, two_q);
      if (!last) {
        radix_put<W, LOGR>(sm, v, U, s);
        continue;
      }
      if constexpr (FINAL) {
        static_for<0, R / 2>([&](auto i) {
          inv_final_butterfly<W, S>(v[i], v[i + R / 2], fin, q, two_q);
          if (omf == 1) {
            v[i] = halve(v[i], q);
            v[i + R / 2] = halve(v[i + R / 2], q);
          }
        });
      }
      store(v, poly, u, s);
    }
    if (!last) radix_sync(warp_mask);
  }
}

// -- K1, K6, K7: one transform or shard per CTA --------------------------------

// One CTA's transform, or shard (first_block = 2^log_d + shard), with x and
// y at its chunk: the forward passes, then the coalesced store. The
// single-modulus kernels below and the stacked ones (ntt_rns.cu) call it.
template <typename W, int S, int LOGR, int G, int LOGN>
__device__ __forceinline__ void radix_fwd_chunk(
    const u64* __restrict__ x, u64* __restrict__ y,
    const u64* __restrict__ rop, const u64* __restrict__ prop, W q,
    int log_n, int omf, int first_block) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  W* sm = reinterpret_cast<W*>(ntt_smem);
  radix_fwd_passes<W, S, LOGR, G, LOGN, false>(
      sm, [&](int) { return x; }, log_n, 1, 0, first_block, rop, prop, q,
      omf);
  radix_fwd_store<W, LOGR, G, false>(sm, [&](int) { return y; }, log_n, 1);
}

// The inverse of one CTA's chunk: the first pass loads a row of R
// consecutive words from global memory, the last stores coalesced (u writes
// y[u + i n/R]); shard `shard` of a transform of 2^log_big_n.
template <typename W, int S, int LOGR, int G, int LOGN, bool FINAL>
__device__ __forceinline__ void radix_inv_chunk(
    const u64* __restrict__ x, u64* __restrict__ y,
    const u64* __restrict__ irop1, const u64* __restrict__ pirop1, W q,
    const InvFinal<W>& fin, int log_n, int omf, int log_big_n, int shard) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  W* sm = reinterpret_cast<W*>(ntt_smem);
  radix_inv_passes<W, S, LOGR, G, LOGN, FINAL, false>(
      sm,
      [&](auto& v, int, int u) {
        radix_load_row<W, LOGR>(v, x + ((long long)u << LOGR));
      },
      [&](auto& v, int, int u, int s) {
        static_for<0, (1 << LOGR)>([&](auto i) {
          y[u + (decltype(i)::value << s)] = v[i];
        });
      },
      log_n, log_big_n, shard, 1, 0, irop1, pirop1, q, fin, omf);
}

template <typename W, int S, int LOGR, int G, int LOGN>
__global__ void __launch_bounds__(1024)
    radix_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ rop,
                     const u64* __restrict__ prop, u64 q64, int log_n_arg,
                     int omf, int log_d, int shard_base, int log_sub) {
  const int log_n = LOGN ? LOGN : log_n_arg;
  const int shard = shard_base + (blockIdx.x & ((1 << log_sub) - 1));
  const long long off = (long long)blockIdx.x << log_n;
  radix_fwd_chunk<W, S, LOGR, G, LOGN>(x + off, y + off, rop, prop, (W)q64,
                                       log_n, omf, (1 << log_d) + shard);
}

template <typename W, int S, int LOGR, int G, int LOGN, bool FINAL>
__global__ void __launch_bounds__(1024)
    radix_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                     const u64* __restrict__ irop1,
                     const u64* __restrict__ pirop1, u64 q64,
                     InvFinal<W> fin, int log_n_arg, int omf, int log_d,
                     int shard_base, int log_sub) {
  const int log_n = LOGN ? LOGN : log_n_arg;
  const int shard = shard_base + (blockIdx.x & ((1 << log_sub) - 1));
  const long long off = (long long)blockIdx.x << log_n;
  radix_inv_chunk<W, S, LOGR, G, LOGN, FINAL>(x + off, y + off, irop1, pirop1,
                                              (W)q64, fin, log_n, omf,
                                              log_n + log_d, shard);
}

// -- K2: P transforms per CTA ---------------------------------------------------

// The `polys` transforms of 2^log_n of one CTA, x and y at its first: the
// packed passes and store (polys_per_cta n/R threads; a ragged CTA holds
// fewer than polys_per_cta).
template <int S, int LOGR>
__device__ __forceinline__ void radix_packed_fwd_polys(
    const u64* __restrict__ x, u64* __restrict__ y,
    const u64* __restrict__ rop, const u64* __restrict__ prop, u64 q,
    int log_n, int polys, int omf) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  u64* sm = reinterpret_cast<u64*>(ntt_smem);
  const auto at = [&](int p) { return (long long)p << log_n; };
  radix_fwd_passes<u64, S, LOGR, 1, 0, true>(
      sm, [&](int p) { return x + at(p); }, log_n, polys,
      packed_warp_mask(log_n - LOGR), 1, rop, prop, q, omf);
  radix_fwd_store<u64, LOGR, 1, true>(sm, [&](int p) { return y + at(p); },
                                      log_n, polys);
}

template <int S, int LOGR>
__device__ __forceinline__ void radix_packed_inv_polys(
    const u64* __restrict__ x, u64* __restrict__ y,
    const u64* __restrict__ irop1, const u64* __restrict__ pirop1, u64 q,
    const InvFinal<u64>& fin, int log_n, int polys, int omf) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  u64* sm = reinterpret_cast<u64*>(ntt_smem);
  const auto at = [&](int p) { return (long long)p << log_n; };
  radix_inv_passes<u64, S, LOGR, 1, 0, true, true>(
      sm,
      [&](auto& v, int p, int u) {
        radix_load_row<u64, LOGR>(v, x + at(p) + ((long long)u << LOGR));
      },
      [&](auto& v, int p, int u, int s) {
        static_for<0, (1 << LOGR)>([&](auto i) {
          y[at(p) + u + (decltype(i)::value << s)] = v[i];
        });
      },
      log_n, log_n, 0, polys, packed_warp_mask(log_n - LOGR), irop1, pirop1,
      q, fin, omf);
}

// `chunks` transforms of 2^log_n, polys_per_cta of them per CTA on
// polys_per_cta n/R threads; the last CTA may hold fewer.
template <int S, int LOGR>
__global__ void __launch_bounds__(1024)
    radix_packed_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                            const u64* __restrict__ rop,
                            const u64* __restrict__ prop, u64 q, int log_n,
                            int chunks, int polys_per_cta, int omf) {
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = (int)min((long long)polys_per_cta, chunks - first);
  radix_packed_fwd_polys<S, LOGR>(x + (first << log_n), y + (first << log_n),
                                  rop, prop, q, log_n, polys, omf);
}

template <int S, int LOGR>
__global__ void __launch_bounds__(1024)
    radix_packed_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                            const u64* __restrict__ irop1,
                            const u64* __restrict__ pirop1, u64 q,
                            InvFinal<u64> fin, int log_n, int chunks,
                            int polys_per_cta, int omf) {
  const long long first = (long long)blockIdx.x * polys_per_cta;
  const int polys = (int)min((long long)polys_per_cta, chunks - first);
  radix_packed_inv_polys<S, LOGR>(x + (first << log_n), y + (first << log_n),
                                  irop1, pirop1, q, fin, log_n, polys, omf);
}

// -- launches ----------------------------------------------------------------

// f(Index<S>{}) for scheme code `scheme` (modarith.cuh Scheme): exact in
// either word, the lean schemes in u64 only, and approx (u64) where the
// caller instantiates it (WITH_APPROX: the single-modulus kernels, whose
// TPU kernels run that form; the stacked ones keep the three schemes of
// the JAX stacked bodies).
template <typename W, bool WITH_APPROX = false, typename F>
static int with_scheme(int scheme, F&& f) {
  if (scheme == EXACT) return f(Index<EXACT>{});
  if constexpr (sizeof(W) == 8) {
    if (scheme == LEAN16) return f(Index<LEAN16>{});
    if (scheme == LEAN8) return f(Index<LEAN8>{});
    if constexpr (WITH_APPROX)
      if (scheme == APPROX) return f(Index<APPROX>{});
  }
  return (int)cudaErrorInvalidValue;
}

// The shape of the radix walk follows the word, log_n and the grid: R = 8
// from n = 8 on, one group a thread up to 2^13 (n/8 threads), two at 2^14
// and four at 2^15 (u32 only: 128 KB), 1024 threads; R = 2 below n = 8.
// In u32, 2^13 and 2^14 also have a form of 512 threads (G = 2 and 4) that
// fits two CTAs a SM (registers and shared memory both), so that one
// CTA's first load overlaps the other's passes: `two_per_sm` takes it
// where the launch has more CTAs than the card has SMs; a launch of one
// wave or less keeps 1024 threads a CTA (PERF.md's findings). From
// 2^10 up, the sizes of K1's, K6's and K7's main paths, log_n is a
// constant of the instantiation.
// f(Index<LOGR>{}, Index<G>{}, Index<LOGN>{}).
template <typename W, typename F>
static int with_shape(int log_n, bool two_per_sm, F&& f) {
  constexpr bool U32 = sizeof(W) == 4;
  switch (log_n) {
    case 15:
      if constexpr (U32) return f(Index<3>{}, Index<4>{}, Index<15>{});
      return (int)cudaErrorInvalidValue;
    case 14:
      if constexpr (U32)
        if (two_per_sm) return f(Index<3>{}, Index<4>{}, Index<14>{});
      return f(Index<3>{}, Index<2>{}, Index<14>{});
    case 13:
      if constexpr (U32)
        if (two_per_sm) return f(Index<3>{}, Index<2>{}, Index<13>{});
      return f(Index<3>{}, Index<1>{}, Index<13>{});
    case 12:
      return f(Index<3>{}, Index<1>{}, Index<12>{});
    case 11:
      return f(Index<3>{}, Index<1>{}, Index<11>{});
    case 10:
      return f(Index<3>{}, Index<1>{}, Index<10>{});
    default:
      if (log_n >= 3) return f(Index<3>{}, Index<1>{}, Index<0>{});
      return f(Index<1>{}, Index<1>{}, Index<0>{});
  }
}

// The SMs of the current device (0 if the runtime cannot say).
static int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The radix walk of scheme code `scheme`: exact in either word, the lean
// schemes and approx in u64 only.
template <typename W>
static int launch_radix_fwd_scheme(int scheme, const u64* x, u64* y,
                                   const u64* rop, const u64* prop, u64 q,
                                   int log_n, int chunks, int omf, int log_d,
                                   int shard_base, int log_sub,
                                   cudaStream_t stream) {
  const bool two_per_sm = chunks > sm_count();
  return with_scheme<W, true>(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_shape<W>(log_n, two_per_sm, [&](auto logr, auto g,
                                                 auto logn) {
      constexpr int LOGR = decltype(logr)::value, G = decltype(g)::value;
      constexpr int LOGN = decltype(logn)::value;
      const size_t smem = ((size_t)1 << log_n) * sizeof(W);
      const int err =
          (int)allow_smem(radix_fwd_kernel<W, S, LOGR, G, LOGN>, smem);
      if (err != 0) return err;
      radix_fwd_kernel<W, S, LOGR, G, LOGN><<<chunks, (1 << log_n) / (G << LOGR), smem, stream>>>(
          x, y, rop, prop, q, log_n, omf, log_d, shard_base, log_sub);
      return (int)cudaGetLastError();
    });
  });
}

template <typename W, bool FINAL>
static int launch_radix_inv_scheme(int scheme, const u64* x, u64* y,
                                   const u64* irop, const u64* pirop, u64 q,
                                   const InvFinal<W>& fin, int log_n,
                                   int chunks, int omf, int log_d,
                                   int shard_base, int log_sub,
                                   cudaStream_t stream) {
  const bool two_per_sm = chunks > sm_count();
  // The kernel takes the tables from entry 1 + N on (radix_inv_pass).
  const size_t skip = 1 + ((size_t)1 << (log_n + log_d));
  return with_scheme<W, true>(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_shape<W>(log_n, two_per_sm, [&](auto logr, auto g,
                                                 auto logn) {
      constexpr int LOGR = decltype(logr)::value, G = decltype(g)::value;
      constexpr int LOGN = decltype(logn)::value;
      const size_t smem = ((size_t)1 << log_n) * sizeof(W);
      const int err = (int)allow_smem(
          radix_inv_kernel<W, S, LOGR, G, LOGN, FINAL>, smem);
      if (err != 0) return err;
      radix_inv_kernel<W, S, LOGR, G, LOGN, FINAL><<<chunks, (1 << log_n) / (G << LOGR), smem, stream>>>(
          x, y, irop + skip, pirop + skip, q, fin, log_n, omf, log_d,
          shard_base, log_sub);
      return (int)cudaGetLastError();
    });
  });
}

// K2's launch: polys_per_cta transforms a CTA on polys_per_cta n/R
// threads (R = 8 from n = 8 on, 2 below), at most 1024. polys_per_cta is
// a power of two, so that the swizzle of the virtual transform of
// polys_per_cta n slots stays within them.
template <typename F>
static int with_packed_shape(int log_n, int polys_per_cta, F&& f) {
  const int logr = log_n >= 3 ? 3 : 1;
  if (polys_per_cta < 2 || (polys_per_cta & (polys_per_cta - 1)) ||
      log_n < 1 || ((long long)polys_per_cta << (log_n - logr)) > 1024)
    return (int)cudaErrorInvalidValue;
  const int threads = polys_per_cta << (log_n - logr);
  const size_t smem = ((size_t)polys_per_cta << log_n) * sizeof(u64);
  if (logr == 3) return f(Index<3>{}, threads, smem);
  return f(Index<1>{}, threads, smem);
}

static int launch_packed_fwd(int scheme, const u64* x, u64* y,
                             const u64* rop, const u64* prop, u64 q,
                             int log_n, int chunks, int polys_per_cta,
                             int omf, cudaStream_t stream) {
  const int grid = (chunks + polys_per_cta - 1) / polys_per_cta;
  return with_scheme<u64, true>(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_packed_shape(log_n, polys_per_cta, [&](auto logr, int threads,
                                                       size_t smem) {
      constexpr int LOGR = decltype(logr)::value;
      const int err = (int)allow_smem(radix_packed_fwd_kernel<S, LOGR>, smem);
      if (err != 0) return err;
      radix_packed_fwd_kernel<S, LOGR><<<grid, threads, smem, stream>>>(
          x, y, rop, prop, q, log_n, chunks, polys_per_cta, omf);
      return (int)cudaGetLastError();
    });
  });
}

static int launch_packed_inv(int scheme, const u64* x, u64* y,
                             const u64* irop, const u64* pirop, u64 q,
                             const InvFinal<u64>& fin, int log_n, int chunks,
                             int polys_per_cta, int omf,
                             cudaStream_t stream) {
  const int grid = (chunks + polys_per_cta - 1) / polys_per_cta;
  const size_t skip = 1 + ((size_t)1 << log_n);
  return with_scheme<u64, true>(scheme, [&](auto s) {
    constexpr int S = decltype(s)::value;
    return with_packed_shape(log_n, polys_per_cta, [&](auto logr, int threads,
                                                       size_t smem) {
      constexpr int LOGR = decltype(logr)::value;
      const int err = (int)allow_smem(radix_packed_inv_kernel<S, LOGR>, smem);
      if (err != 0) return err;
      radix_packed_inv_kernel<S, LOGR><<<grid, threads, smem, stream>>>(
          x, y, irop + skip, pirop + skip, q, fin, log_n, chunks,
          polys_per_cta, omf);
      return (int)cudaGetLastError();
    });
  });
}
