// K5's tiled form: the cross pass of ntt_hier.cu on tiles of the
// (batch, D, lc) block in shared memory, built at every D (2 .. 64) and
// taken where the column form stays under half of its bound
// (hexl_tpu_torch/ntt/hier.py::cross_form).
//
// What it computes is the column form's (cross_fwd_kernel,
// cross_inv_kernel), bit for bit: the forward stages of stride >= lc on
// the D = 2^LOG_D rows, or the inverse ones ending with the global final
// stage fused with N^-1 and the OMF (FINAL) or with an ordinary stage; the
// same twiddle tables, row groups (log_groups) and approximate schemes.
//
// Why a second form. The column form gives a thread one column, all D of
// its coefficients in registers: at D = 64 in u64 that is 128 registers of
// coefficients and 254 in all, two CTAs of 128 threads an SM, and each
// thread loads its 64 rows, runs its six stages and stores, so nothing
// hides one column's memory traffic behind another's butterflies. At D =
// 64 the butterflies' issue (six stages of 64-bit Shoup products) costs
// about as much as the bytes, and the column form pays their sum.
//
// The design:
// - A tile is C = TILE_COEFFS / D consecutive columns of one block, D
//   rows x C columns, 8 KB of u64 whatever D (C = 16 at D = 64, 512 at
//   D = 2). A launch needs lc >= C; the wrapper's rule keeps the column
//   form otherwise.
// - A persistent CTA walks the tiles t = blockIdx.x, + gridDim.x, ... with
//   a ring of TILE_RING tile buffers. The tiles arrive by cp.async, 16
//   bytes a thread (consecutive threads on consecutive 16 bytes of a row),
//   committed one group a tile, so the next tiles' copies are in flight
//   while tile t's butterflies run, and the stores of tile t - 1
//   (ordinary st.global, which do not stall the thread) drain meanwhile.
//   The grid is TILE_CTAS_PER_SM CTAs an SM (or fewer, as occupancy
//   allows), which keeps the copies in flight near what the memory
//   needs rather than the whole input at once.
// - The log2(D) stages run as radix passes of up to 3 stages over the
//   rows: an item is one column's 2^k coefficients of a group of rows (k
//   the pass's stages), so a thread holds 8 coefficients (16 registers in
//   u64), not D. A barrier goes between passes; the last pass writes its
//   coefficients straight to device memory.
// - Each phase of a warp's shared-memory access (16 lanes of 8 bytes, 8
//   lanes of 16 bytes) takes consecutive columns of one row (C >= 16 at
//   every D), 128 contiguous bytes, so every access is free of bank
//   conflicts without a swizzle; a CPU test
//   (tests/test_torch_cross_tile.py) counts them.
// - The twiddle tables are staged once per CTA, before the ring, as the
//   column form stages them.
// What bounds it on an H100: the bytes (16 a coefficient a direction) and
// the issue of the 64-bit butterflies' integer instructions, now able to
// run side by side. The constants were chosen on the card among ring
// depths of 1-4, tiles of 1024-4096 coefficients, 128-512 threads and 1
// to 8 CTAs an SM (chip_smoke.py --k5-variants; PERF.md): at D = 64 in
// u64 all but the one-CTA-an-SM grids came within 51-56% of the bytes
// bound, so what is left is taken to be the butterflies' issue (about 50
// integer instructions each on the SM's 64 INT32 lanes), not the copies.
#pragma once

#include "modarith.cuh"
#include "radix.cuh"

constexpr int TILE_THREADS = 128;
constexpr int LOG_TILE = 10;
constexpr int TILE_COEFFS = 1 << LOG_TILE;  // a tile's coefficients
constexpr int TILE_RING = 3;        // tile buffers a CTA cycles through
// The persistent grid's CTAs an SM at most (0: as many as fit; -1: no
// persistent walk, one CTA a tile; the variants of chip_smoke.py).
constexpr int TILE_CTAS_PER_SM = 2;

// The shape of the tiled form at D = 2^LOG_D: C = 2^LOG_C columns, the
// passes' stage counts (as even as they can be, the first ones larger).
template <int LOG_D>
struct TileShape {
  static constexpr int D = 1 << LOG_D;
  static constexpr int LOG_C = LOG_TILE - LOG_D;
  static constexpr int C = 1 << LOG_C;
  static constexpr int PASSES = (LOG_D + 2) / 3;
  __host__ __device__ static constexpr int stages(int p) {
    return LOG_D / PASSES + (p < LOG_D % PASSES ? 1 : 0);
  }
  // The first stage of pass p (forward order; the inverse counts its
  // strides the same way from stride 1).
  __host__ __device__ static constexpr int first(int p) {
    return p == 0 ? 0 : first(p - 1) + stages(p - 1);
  }
  static_assert(TILE_COEFFS % (2 * TILE_THREADS) == 0, "whole 16-byte copies");
};

// 16 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where tile t of a (batch, 2^LOG_D, 2^log_lc) block starts, and its block.
template <int LOG_D>
__device__ __forceinline__ long long tile_base(long long t, int log_lc,
                                               long long& block) {
  constexpr int LOG_C = TileShape<LOG_D>::LOG_C;
  const int per_block = log_lc - LOG_C;
  block = t >> per_block;
  return (block << (LOG_D + log_lc)) +
         ((t & ((1LL << per_block) - 1)) << LOG_C);
}

// Tile t's copies into buf (a no-op past the last tile), and one commit
// group either way, so that every thread counts the same groups.
template <int LOG_D>
__device__ __forceinline__ void tile_load(u64* buf, const u64* x,
                                          long long t, long long tiles,
                                          int log_lc) {
  constexpr int LOG_C = TileShape<LOG_D>::LOG_C;
  if (t < tiles) {
    long long block;
    const long long base = tile_base<LOG_D>(t, log_lc, block);
    for (int i = threadIdx.x; i < TILE_COEFFS / 2; i += TILE_THREADS) {
      const int row = i >> (LOG_C - 1);
      const int col = (i << 1) & ((1 << LOG_C) - 1);
      cp_async16(buf + (row << LOG_C) + col,
                 x + base + ((long long)row << log_lc) + col);
    }
  }
  cp_async_commit();
}

// The twiddles of a launch in dynamic shared memory, narrowed to W; the
// tile ring follows them at `ring`.
template <typename W>
__device__ __forceinline__ void tile_smem(W*& tw, W*& twp, u64*& ring,
                                          const u64* __restrict__ w,
                                          const u64* __restrict__ wp,
                                          int entries, int capacity) {
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  tw = reinterpret_cast<W*>(ntt_smem);
  twp = tw + capacity;
  ring = reinterpret_cast<u64*>(twp + capacity);
  for (int i = threadIdx.x; i < entries; i += TILE_THREADS) {
    tw[i] = (W)w[i];
    twp[i] = (W)wp[i];
  }
}

// The persistent walk over the tiles: body(buf, tile) runs the passes on
// a tile resting in buf, its last pass storing to device memory.
template <int LOG_D, typename Body>
__device__ __forceinline__ void tile_walk(u64* ring, const u64* x,
                                          long long tiles, int log_lc,
                                          Body&& body) {
  constexpr int STRIDE = TILE_COEFFS;
  static_for<0, TILE_RING>([&](auto r) {
    tile_load<LOG_D>(ring + decltype(r)::value * STRIDE, x,
                     blockIdx.x + (long long)decltype(r)::value * gridDim.x,
                     tiles, log_lc);
  });
  int slot = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    u64* buf = ring + slot * STRIDE;
    cp_async_wait<TILE_RING - 1>();
    __syncthreads();   // every thread's copies of tile t have landed
    body(buf, t);
    __syncthreads();   // every thread is done with buf
    tile_load<LOG_D>(buf, x, t + (long long)TILE_RING * gridDim.x, tiles,
                     log_lc);
    slot = slot + 1 == TILE_RING ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// Pass P of a tile: each item (a column of a group of 2^K rows) is loaded
// from buf, run through f(v, g) and stored to buf or, in the last pass, to
// y. The group's rows are base + j * 2^ls (j < 2^K), base = g with K zero
// bits inserted at bit ls.
template <typename W, int LOG_D, int K, bool LAST, typename F>
__device__ __forceinline__ void tile_pass(u64* buf, u64* y, long long base,
                                          int log_lc, int ls, F&& f) {
  constexpr int LOG_C = TileShape<LOG_D>::LOG_C;
  constexpr int ITEMS = TILE_COEFFS >> K;
  for (int w = threadIdx.x; w < ITEMS; w += TILE_THREADS) {
    const int col = w & ((1 << LOG_C) - 1);
    const int g = w >> LOG_C;
    const int first = (g & ((1 << ls) - 1)) | ((g >> ls) << (ls + K));
    W v[1 << K];
    static_for<0, (1 << K)>([&](auto j) {
      v[j] = (W)buf[((first + (decltype(j)::value << ls)) << LOG_C) + col];
    });
    f(v, g);
    static_for<0, (1 << K)>([&](auto j) {
      const int row = first + (decltype(j)::value << ls);
      if constexpr (LAST) {
        y[base + ((long long)row << log_lc) + col] = v[j];
      } else {
        buf[(row << LOG_C) + col] = v[j];
      }
    });
  }
}

// The forward cross pass on tiles (cross_fwd_kernel's function), walked
// by the CTAs along blockIdx.x: the single-modulus kernel's whole launch,
// or one row's CTAs of a stacked one (cross_rns.cu).
template <typename W, int S, int LOG_D>
__device__ __forceinline__ void cross_tile_fwd_tiles(
    const u64* __restrict__ x, u64* __restrict__ y,
    const u64* __restrict__ rop, const u64* __restrict__ prop, u64 q64,
    int log_lc, int log_groups, long long tiles) {
  using Shape = TileShape<LOG_D>;
  constexpr int D = Shape::D;
  W *tw, *twp;
  u64* ring;
  tile_smem(tw, twp, ring, rop, prop, D << log_groups, D << log_groups);
  const int groups = 1 << log_groups;
  const W q = (W)q64;
  const W two_q = 2 * q;
  tile_walk<LOG_D>(ring, x, tiles, log_lc, [&](u64* buf, long long t) {
    long long block;
    const long long base = tile_base<LOG_D>(t, log_lc, block);
    const int base_m = groups + (int)(block & (groups - 1));
    static_for<0, Shape::PASSES>([&](auto p) {
      constexpr int P = decltype(p)::value;
      constexpr int K = Shape::stages(P);
      constexpr int S0 = Shape::first(P);
      constexpr int LS = LOG_D - S0 - K;   // the group's row stride, log2
      if constexpr (P > 0) __syncthreads();
      tile_pass<W, LOG_D, K, P + 1 == Shape::PASSES>(
          buf, y, base, log_lc, LS, [&](W(&v)[1 << K], int g) {
            const int b = g >> LS;   // the group's block at stage S0
            // Local stage i (stage S0 + i, m = 2^(S0 + i) blocks): pairs
            // j and j + 2^(K-1-i), block (b << i) + (j >> (K - i)).
            static_for<0, K>([&](auto i) {
              constexpr int I = decltype(i)::value;
              constexpr int H = 1 << (K - 1 - I);
              const int at = (base_m << (S0 + I)) + (b << I);
              static_for<0, (1 << K) / 2>([&](auto u) {
                constexpr int U = decltype(u)::value;
                constexpr int J = (U / H) * 2 * H + U % H;
                fwd_butterfly<W, S>(v[J], v[J + H], tw[at + (J >> (K - I))],
                                    twp[at + (J >> (K - I))], q, two_q);
              });
            });
          });
    });
  });
}

// The inverse cross pass on tiles (cross_inv_kernel's function): the stage
// at stride 2^h pairs rows r and r + 2^h, block r >> (h + 1) of its
// m = D / 2^(h+1) at table entry (D - 2m) G + g m + block.
template <typename W, int S, int LOG_D, bool FINAL>
__device__ __forceinline__ void cross_tile_inv_tiles(
    const u64* __restrict__ x, u64* __restrict__ y,
    const u64* __restrict__ irop_cross, const u64* __restrict__ pirop_cross,
    u64 q64, const InvFinal<W>& fin, int omf, int log_lc, int log_groups,
    long long tiles) {
  using Shape = TileShape<LOG_D>;
  constexpr int D = Shape::D;
  const int groups = FINAL ? 1 : 1 << log_groups;
  W *tw, *twp;
  u64* ring;
  tile_smem(tw, twp, ring, irop_cross, pirop_cross,
            FINAL ? D - 2 : (D - 1) * groups, D * groups);
  const W q = (W)q64;
  const W two_q = 2 * q;
  tile_walk<LOG_D>(ring, x, tiles, log_lc, [&](u64* buf, long long t) {
    long long block;
    const long long base = tile_base<LOG_D>(t, log_lc, block);
    const int group = FINAL ? 0 : (int)(block & (groups - 1));
    static_for<0, Shape::PASSES>([&](auto p) {
      constexpr int P = decltype(p)::value;
      constexpr int K = Shape::stages(P);
      constexpr int H0 = Shape::first(P);   // the pass's least stride, log2
      constexpr bool LAST = P + 1 == Shape::PASSES;
      if constexpr (P > 0) __syncthreads();
      tile_pass<W, LOG_D, K, LAST>(
          buf, y, base, log_lc, H0, [&](W(&v)[1 << K], int g) {
            const int b = g >> H0;   // rows b 2^(H0+K) .. : the group's span
            // Local stage i (stride 2^(H0 + i)): pairs j and j + 2^i,
            // block (b << (K - 1 - i)) + (j >> (i + 1)).
            static_for<0, K>([&](auto i) {
              constexpr int I = decltype(i)::value;
              constexpr int H = 1 << I;
              constexpr int M_LOG = LOG_D - 1 - H0 - I;   // log2 m
              if constexpr (FINAL && LAST && I + 1 == K) {
                static_for<0, (1 << K) / 2>([&](auto u) {
                  constexpr int J = decltype(u)::value;
                  inv_final_butterfly<W, S>(v[J], v[J + H], fin, q, two_q);
                });
                if (omf == 1) {
                  static_for<0, (1 << K)>([&](auto j) {
                    v[j] = halve(v[j], q);
                  });
                }
              } else {
                const int at = ((D - (2 << M_LOG)) * groups) +
                               (group << M_LOG) + (b << (K - 1 - I));
                static_for<0, (1 << K) / 2>([&](auto u) {
                  constexpr int U = decltype(u)::value;
                  constexpr int J = (U / H) * 2 * H + U % H;
                  inv_butterfly<W, S>(v[J], v[J + H], tw[at + (J >> (I + 1))],
                                      twp[at + (J >> (I + 1))], q, two_q);
                });
              }
            });
          });
    });
  });
}

template <typename W, int S, int LOG_D>
__global__ void __launch_bounds__(TILE_THREADS)
    cross_tile_fwd_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                          const u64* __restrict__ rop,
                          const u64* __restrict__ prop, u64 q64, int log_lc,
                          int log_groups, long long tiles) {
  cross_tile_fwd_tiles<W, S, LOG_D>(x, y, rop, prop, q64, log_lc, log_groups,
                                    tiles);
}

template <typename W, int S, int LOG_D, bool FINAL>
__global__ void __launch_bounds__(TILE_THREADS)
    cross_tile_inv_kernel(const u64* __restrict__ x, u64* __restrict__ y,
                          const u64* __restrict__ irop_cross,
                          const u64* __restrict__ pirop_cross, u64 q64,
                          InvFinal<W> fin, int omf, int log_lc,
                          int log_groups, long long tiles) {
  cross_tile_inv_tiles<W, S, LOG_D, FINAL>(x, y, irop_cross, pirop_cross,
                                           q64, fin, omf, log_lc, log_groups,
                                           tiles);
}

// The tiled form's shared memory: the twiddle tables of 2^log_table
// entries each and the ring.
template <typename W>
__host__ __device__ constexpr size_t tile_smem_bytes(int log_table) {
  return ((size_t)2 * sizeof(W) << log_table) +
         (size_t)TILE_RING * TILE_COEFFS * sizeof(u64);
}

// A persistent grid: as many CTAs as the card holds at once, at most one
// a tile (0 when the occupancy query fails).
template <typename Kernel>
static int tile_grid(Kernel kernel, size_t smem, long long tiles) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    TILE_THREADS, smem) !=
          cudaSuccess)
    return 0;
  if (TILE_CTAS_PER_SM < 0) return tiles > 0x7fffffffLL ? 0 : (int)tiles;
  if (TILE_CTAS_PER_SM > 0 && per_sm > TILE_CTAS_PER_SM)
    per_sm = TILE_CTAS_PER_SM;
  const long long grid = (long long)sms * per_sm;
  return (int)(grid < tiles ? grid : tiles);
}
