// K3: the fused negacyclic polynomial product, one launch per call.
//
// Replaces the TPU kernel hexl_tpu/poly.py::_poly_mult_pallas: fwd(a) and
// fwd(b) to [0, 4q), Barrett mult_mod at IMF 4, then the inverse to [0, q),
// with no intermediate in device memory. Every transform is the radix walk
// of ntt_block.cuh, and the product is formed in the inverse's first load,
// so each operand coefficient is read once and each output written once.
//
// What bounds it on an H100: it reads 16 and writes 8 bytes per
// coefficient and runs three transforms' butterflies plus one Barrett
// product per coefficient, about three times the NTT's multiplies on 1.5
// times its bytes: bound by the issue of the 64-bit butterflies, as K1.
// Two things stand in the way at N = 2^14. Two operands need 256 KB of
// shared memory and a CTA has 227 KB; and one CTA per pair fills only as
// many SMs as there are pairs (64 of 132 on the main path). The cluster
// form answers both: a pair is a cluster of two CTAs on two SMs, CTA r
// transforms operand r (a or b) into its own shared memory, and after a
// cluster barrier each CTA reads the other's transform through
// distributed shared memory. CTA r then owns half r of the product
// (positions [r N/2, (r+1) N/2)): it forms it in the first load of its
// inverse, runs the inverse stages of stride < N/2 on it as shard r of
// two (they never cross the halves), and after a second cluster barrier
// runs the final stage (stride N/2, fused with N^-1 and the OMF
// reduction) for a quarter of the butterflies, one operand of each read
// locally and one remotely, storing both outputs coalesced; a last
// cluster barrier keeps each CTA's shared memory alive while the other
// reads it. The swizzle of the slots only moves bits 0-4 by bits 3-7, so
// from N = 2^9 on the forward's slot of position r N/2 + j is r N/2 plus
// the shard's slot of j, and the product maps one layout onto the other
// with no exchange. The form serves 2^12-2^14.
//
// The one-CTA form (N <= 2^13, 16N bytes of shared memory) runs both
// forwards in one CTA as two packed transforms (ntt_block.cuh PACKED, a
// at the slots of 0 .. N-1 and b of N .. 2N-1), then the whole inverse
// with the product in its first load. hexl_tpu_torch/poly.py::form_for
// picks it below 2^12, and at 2^12-2^13 where the cluster's 2 x batch CTAs
// would outnumber the SMs: there the card showed it faster, the cluster's
// second CTA then sharing an SM instead of filling an idle one.
#include <cooperative_groups.h>

#include "ntt_block.cuh"

namespace cg = cooperative_groups;

// mult_mod at IMF 4: mu and shift of mult_mod_barrett.
struct Barrett {
  u64 q, mu;
  int shift;
};

// The product of two forward outputs in [0, 4q), in [0, q).
__device__ __forceinline__ u64 product(u64 a, u64 b, const Barrett& m) {
  return mult_mod_barrett(reduce_lazy<u64>(a, m.q, 4),
                          reduce_lazy<u64>(b, m.q, 4), m.q, m.mu, m.shift);
}

// The inverse's first-pass group u (R consecutive positions j at s = 0) of
// the product of two forward outputs, position j of each at the radix slot
// of ja + j in fa and of jb + j in fb.
template <int LOGR>
__device__ __forceinline__ void product_row(u64 (&v)[1 << LOGR],
                                            const u64* fa, const u64* fb,
                                            int ja, int jb, int u,
                                            const Barrett& m) {
  static_for<0, (1 << LOGR)>([&](auto i) {
    const int j = (u << LOGR) + decltype(i)::value;
    v[i] = product(fa[radix_slot<LOGR>(ja + j)], fb[radix_slot<LOGR>(jb + j)],
                   m);
  });
}

// The cluster form: CTAs 2c and 2c + 1 hold pair c, n / 16 threads each,
// the forward in two groups a thread, the half's inverse in one.
template <int LOGN>
__global__ void __launch_bounds__(1024)
    poly_cluster_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                        u64* __restrict__ out, const u64* __restrict__ rop,
                        const u64* __restrict__ prop,
                        const u64* __restrict__ irop1,
                        const u64* __restrict__ pirop1, Barrett m,
                        InvFinal<u64> fin) {
  static_assert(LOGN >= 9, "the halves' slots coincide from 2^9 on");
  constexpr int LOGR = 3, HALF = 1 << (LOGN - 1);
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  u64* sm = reinterpret_cast<u64*>(ntt_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const long long off = (long long)(blockIdx.x >> 1) << LOGN;
  const u64 q = m.q;

  radix_fwd_passes<u64, EXACT, LOGR, 2, LOGN, false>(
      sm, [&](int) { return (r ? b : a) + off; }, LOGN, 1, 0, 1, rop, prop,
      q, 4);
  cluster.sync();

  // Half r of the product, positions r N/2 + j: the shard's slot of j is
  // the transform's slot of r N/2 + j less r N/2.
  const u64* other = cluster.map_shared_rank(sm, r ^ 1);
  u64* mine = sm + r * HALF;
  radix_inv_passes<u64, EXACT, LOGR, 1, LOGN - 1, false, false>(
      mine,
      [&](auto& v, int, int u) {
        product_row<LOGR>(v, sm, other, r * HALF, r * HALF, u, m);
      },
      [&](auto& v, int, int u, int s) { radix_put<u64, LOGR>(mine, v, u, s); },
      LOGN - 1, LOGN, r, 1, 0, irop1, pirop1, q, fin, 1);
  cluster.sync();

  // Half 0 of the inverse rests in CTA 0, half 1 in CTA 1, at the slots of
  // their positions.
  const u64* lo = r == 0 ? sm : other;
  const u64* hi = (r == 1 ? sm : other) + HALF;
  const u64 two_q = 2 * q;
  static_for<0, 4>([&](auto k) {
    const int i = r * (HALF / 2) + threadIdx.x + decltype(k)::value * blockDim.x;
    const int slot = radix_slot<LOGR>(i);
    u64 x = lo[slot], y = hi[slot];
    inv_final_butterfly<u64, EXACT>(x, y, fin, q, two_q);
    out[off + i] = halve(x, q);
    out[off + i + HALF] = halve(y, q);
  });
  cluster.sync();
}

// The one-CTA form: n / R threads, the two forwards as two packed
// transforms (group h of a thread is operand h's), the inverse of the
// product stored through its fused final stage.
template <int LOGR, int LOGN>
__global__ void __launch_bounds__(1024)
    poly_cta_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                    u64* __restrict__ out, const u64* __restrict__ rop,
                    const u64* __restrict__ prop,
                    const u64* __restrict__ irop1,
                    const u64* __restrict__ pirop1, Barrett m,
                    InvFinal<u64> fin, int log_n_arg) {
  const int log_n = LOGN ? LOGN : log_n_arg;
  extern __shared__ __align__(16) unsigned char ntt_smem[];
  u64* sm = reinterpret_cast<u64*>(ntt_smem);
  const long long off = (long long)blockIdx.x << log_n;
  radix_fwd_passes<u64, EXACT, LOGR, 2, LOGN, true>(
      sm, [&](int p) { return (p ? b : a) + off; }, log_n, 2, 0, 1, rop,
      prop, m.q, 4);
  // a's position j at the slot of j, b's at that of n + j.
  radix_inv_passes<u64, EXACT, LOGR, 1, LOGN, true, false>(
      sm,
      [&](auto& v, int, int u) {
        product_row<LOGR>(v, sm, sm, 0, 1 << log_n, u, m);
      },
      [&](auto& v, int, int u, int s) {
        static_for<0, (1 << LOGR)>([&](auto i) {
          out[off + u + (decltype(i)::value << s)] = v[i];
        });
      },
      log_n, log_n, 0, 1, 0, irop1, pirop1, m.q, fin, 1);
}

// -- launches ----------------------------------------------------------------

enum Form : int { CLUSTER = 0, ONE_CTA = 1 };

// The cluster form's kernel for 2^12 <= n <= 2^14 (where the card showed
// it faster than the one-CTA form, hexl_tpu_torch/poly.py::form_for):
// f(kernel, threads, smem).
template <typename F>
static int with_cluster_kernel(int log_n, F&& f) {
  const int threads = (1 << log_n) / 16;
  const size_t smem = ((size_t)1 << log_n) * sizeof(u64);
  switch (log_n) {
    case 14: return f(poly_cluster_kernel<14>, threads, smem);
    case 13: return f(poly_cluster_kernel<13>, threads, smem);
    case 12: return f(poly_cluster_kernel<12>, threads, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A launch configuration of `pairs` clusters of two CTAs.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int pairs, int threads, size_t smem, cudaStream_t stream) {
    attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 2;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(2 * pairs);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The one-CTA form's kernel: R = 8 from n = 8 on, 2 below, n / R threads;
// log_n a constant of the instantiation from 2^10 up.
template <typename F>
static int with_cta_kernel(int log_n, F&& f) {
  const size_t smem = ((size_t)2 << log_n) * sizeof(u64);
  switch (log_n) {
    case 13: return f(poly_cta_kernel<3, 13>, (1 << log_n) / 8, smem);
    case 12: return f(poly_cta_kernel<3, 12>, (1 << log_n) / 8, smem);
    case 11: return f(poly_cta_kernel<3, 11>, (1 << log_n) / 8, smem);
    case 10: return f(poly_cta_kernel<3, 10>, (1 << log_n) / 8, smem);
    default:
      if (log_n > 13 || log_n < 1) return (int)cudaErrorInvalidValue;
      if (log_n >= 3) return f(poly_cta_kernel<3, 0>, (1 << log_n) / 8, smem);
      return f(poly_cta_kernel<1, 0>, (1 << log_n) / 2, smem);
  }
}

// form: CLUSTER (2^12 <= n <= 2^14) or ONE_CTA (n <= 2^13).
extern "C" int hexl_poly_mult(const u64* a, const u64* b, u64* out,
                              const u64* rop, const u64* prop,
                              const u64* irop, const u64* pirop, u64 q,
                              u64 mu, int shift, u64 inv_n, u64 inv_n_precon,
                              u64 inv_n_w, u64 inv_n_w_precon, int log_n,
                              int batch, int form, cudaStream_t stream) {
  const InvFinal<u64> fin = {inv_n, inv_n_precon, inv_n_w, inv_n_w_precon};
  const Barrett m = {q, mu, shift};
  // The kernels take the inverse tables from entry 1 + N on.
  const size_t skip = 1 + ((size_t)1 << log_n);
  const u64 *irop1 = irop + skip, *pirop1 = pirop + skip;
  if (form == CLUSTER) {
    if (batch > (1 << 30)) return (int)cudaErrorInvalidValue;
    return with_cluster_kernel(log_n, [&](auto kernel, int threads,
                                          size_t smem) {
      const int err = (int)allow_smem(kernel, smem);
      if (err != 0) return err;
      ClusterLaunch launch(batch, threads, smem, stream);
      return (int)cudaLaunchKernelEx(&launch.cfg, kernel, a, b, out, rop,
                                     prop, irop1, pirop1, m, fin);
    });
  }
  if (form != ONE_CTA) return (int)cudaErrorInvalidValue;
  return with_cta_kernel(log_n, [&](auto kernel, int threads, size_t smem) {
    const int err = (int)allow_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<batch, threads, smem, stream>>>(a, b, out, rop, prop, irop1,
                                             pirop1, m, fin, log_n);
    return (int)cudaGetLastError();
  });
}

// The most clusters of the cluster form at log_n the device can hold at
// once (cudaOccupancyMaxActiveClusters), written to *clusters.
extern "C" int hexl_poly_max_active_clusters(int log_n, int* clusters) {
  return with_cluster_kernel(log_n, [&](auto kernel, int threads,
                                        size_t smem) {
    const int err = (int)allow_smem(kernel, smem);
    if (err != 0) return err;
    ClusterLaunch launch(1, threads, smem, 0);
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &launch.cfg);
  });
}
