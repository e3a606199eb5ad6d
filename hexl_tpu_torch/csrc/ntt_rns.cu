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
// (132 SMs), and 8 k CTAs as one, without k launch gaps. Under one wave
// a transform or shard runs on a cluster of CTAs instead (K1.rns.cl,
// K6.rns.cl, and K6.shard.cl for a DistNTT position's shard on the
// one-row plan of its prime: ntt_cluster.cuh, launched below; the rule is
// hexl_tpu_torch/ntt/rns.py cluster_for).
#include <mutex>
#include <set>
#include <tuple>

#include "ntt_block.cuh"
#include "ntt_cluster.cuh"
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

// -- the cluster form (ntt_cluster.cuh) ------------------------------------

// f(Index<LOG_C>{}) for a cluster of 2^log_c = 2 .. 16 CTAs.
template <typename F>
static int with_log_c(int log_c, F&& f) {
  switch (log_c) {
    case 1: return f(Index<1>{});
    case 2: return f(Index<2>{});
    case 3: return f(Index<3>{});
    case 4: return f(Index<4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The cluster form's chunks of 2^log_chunk: a transform of 2^12 .. 2^14 on
// 2^LOG_C CTAs, f(Index<LOGN>{}) with LOGN = log_chunk from 2^10 up (a
// constant of the instantiation), else 0.
template <int LOG_C, typename F>
static int with_cluster_chunk(int log_chunk, F&& f) {
  constexpr int LO = 12 - LOG_C, HI = 14 - LOG_C;
  if (log_chunk < LO || log_chunk > HI) return (int)cudaErrorInvalidValue;
  if constexpr (HI >= 13)
    if (log_chunk == 13) return f(Index<13>{});
  if constexpr (HI >= 12 && LO <= 12)
    if (log_chunk == 12) return f(Index<12>{});
  if constexpr (HI >= 11 && LO <= 11)
    if (log_chunk == 11) return f(Index<11>{});
  if constexpr (HI >= 10 && LO <= 10)
    if (log_chunk == 10) return f(Index<10>{});
  if constexpr (LO < 10) return f(Index<0>{});
  return (int)cudaErrorInvalidValue;
}

// A launch configuration of clusters of `cluster` CTAs along x.
struct RnsClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  RnsClusterLaunch(dim3 grid, int cluster, int threads, size_t smem,
                   cudaStream_t stream) {
    attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The kernel's opt-ins: its shared memory, and clusters of 16 (beyond the
// portable 8); made once a kernel, device and size: set on every launch,
// they cost the host more than the launch itself (chip_smoke.py's host
// time per forward call).
template <typename Kernel>
static int allow_cluster(Kernel kernel, int cluster, size_t smem) {
  static std::mutex lock;
  static std::set<std::tuple<const void*, int, size_t>> done;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return (int)cudaGetLastError();
  const auto key = std::make_tuple((const void*)kernel, device, smem);
  std::lock_guard<std::mutex> guard(lock);
  if (done.count(key)) return 0;
  int err = (int)allow_smem(kernel, smem);
  if (err == 0 && cluster > 8)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == 0) done.insert(key);
  return err;
}

// f(kernel, cluster, threads, smem) for the cluster form's kernel of a
// transform or shard of 2^log_n (2^12 .. 2^14) on 2^log_c CTAs: the
// forward, the inverse of a whole transform (log_d = 0) or of a shard
// (log_d > 0).
template <typename F>
static int with_cluster_kernel(bool forward, int log_n, int log_d, int log_c,
                               F&& f) {
  if (log_n < 12 || log_n > 14 || log_d < 0)
    return (int)cudaErrorInvalidValue;
  return with_log_c(log_c, [&](auto lc) {
    constexpr int LOG_C = decltype(lc)::value;
    return with_cluster_chunk<LOG_C>(log_n - LOG_C, [&](auto logn) {
      constexpr int LOGN = decltype(logn)::value;
      const int log_chunk = log_n - LOG_C;
      const int threads = 1 << (log_chunk - 3);
      const size_t smem = ((size_t)1 << log_chunk) * sizeof(u64);
      if (forward)
        return f(rns_cluster_fwd_kernel<LOG_C, LOGN>, 1 << LOG_C, threads,
                 smem);
      if (log_d == 0)
        return f(rns_cluster_inv_kernel<LOG_C, LOGN, true>, 1 << LOG_C,
                 threads, smem);
      return f(rns_cluster_inv_kernel<LOG_C, LOGN, false>, 1 << LOG_C,
               threads, smem);
    });
  });
}

// The cluster form on `chunks` chunks of 2^log_n a row, a cluster of
// 2^log_c CTAs each: chunk t is shard shard_base + (t mod 2^log_sub) of
// the 2^log_d of a transform of 2^(log_n + log_d). K1.rns.cl (log_d = 0:
// whole transforms), K6.rns.cl (shard base 0, period 2^log_d: every 2^14
// shard of each transform) and K6.shard.cl (a DistNTT position's shard,
// or its sub-shards).
static int launch_rns_cluster(bool forward, const u64* x, u64* y,
                              const RnsRow* rows, int k, int log_n, int log_d,
                              int shard_base, int log_sub, long long chunks,
                              int log_c, int omf, cudaStream_t stream) {
  dim3 grid;
  if (log_c < 1 || log_d < 0 || log_n + log_d > 30 || log_sub < 0 ||
      log_sub > log_d || shard_base < 0 ||
      shard_base + (1LL << log_sub) > (1LL << log_d) || chunks > (1LL << 30) ||
      !rns_grid(k, chunks << log_c, grid))
    return (int)cudaErrorInvalidValue;
  return with_cluster_kernel(forward, log_n, log_d, log_c, [&](auto kernel,
                                                               int cluster,
                                                               int threads,
                                                               size_t smem) {
    const int err = allow_cluster(kernel, cluster, smem);
    if (err != 0) return err;
    RnsClusterLaunch launch(grid, cluster, threads, smem, stream);
    const int log_chunk = log_n - log_c;
    const int launched =
        (int)cudaLaunchKernelEx(&launch.cfg, kernel, x, y, rows, log_chunk,
                                omf, log_d, shard_base, log_sub);
    return launched != 0 ? launched : (int)cudaGetLastError();
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

// The cluster form (K1.rns.cl for log_d = 0, K6.rns.cl and K6.shard.cl
// above): a (k, chunks, 2^log_n) block, row i under rows[i], each chunk of
// 2^log_n (2^12 .. 2^14) on a cluster of 2^log_c CTAs; chunk t is shard
// shard_base + (t mod 2^log_sub) of the 2^log_d of a transform of
// 2^(log_n + log_d) (the split: base 0, period 2^log_d; a DistNTT
// position: its shard, or its first 2^14 sub-shard and their count). The
// inverse of a shard stops before the global final stage and ignores omf.
extern "C" int hexl_rns_cluster_fwd(const u64* x, u64* y, const void* rows,
                                    int k, int log_n, int log_d,
                                    int shard_base, int log_sub, int chunks,
                                    int log_c, int omf, cudaStream_t stream) {
  return launch_rns_cluster(true, x, y, static_cast<const RnsRow*>(rows), k,
                            log_n, log_d, shard_base, log_sub, chunks, log_c,
                            omf, stream);
}

extern "C" int hexl_rns_cluster_inv(const u64* x, u64* y, const void* rows,
                                    int k, int log_n, int log_d,
                                    int shard_base, int log_sub, int chunks,
                                    int log_c, int omf, cudaStream_t stream) {
  return launch_rns_cluster(false, x, y, static_cast<const RnsRow*>(rows), k,
                            log_n, log_d, shard_base, log_sub, chunks, log_c,
                            omf, stream);
}

// The most clusters of 2^log_c CTAs of the cluster form at 2^log_n the
// device can hold at once (cudaOccupancyMaxActiveClusters), written to
// *clusters.
extern "C" int hexl_rns_cluster_max_active(int log_n, int log_c,
                                           int* clusters) {
  return with_cluster_kernel(true, log_n, 0, log_c, [&](auto kernel,
                                                        int cluster,
                                                        int threads,
                                                        size_t smem) {
    const int err = allow_cluster(kernel, cluster, smem);
    if (err != 0) return err;
    RnsClusterLaunch launch(dim3(cluster), cluster, threads, smem, 0);
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &launch.cfg);
  });
}
