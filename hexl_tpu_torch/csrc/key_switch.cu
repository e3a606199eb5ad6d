// K10 and K11: the key switch's multiply-accumulate with its Barrett-128
// flush, and its mod-down (two entries: the spread and the fold).
//
// These replace XLA-fused jnp of hexl_tpu/experimental/key_switch.py, which
// has no Pallas kernel for them:
// - K10 (key_switch.py:172-224 with _barrett_reduce_128, :34-93): for each
//   RNS row i, key component k and coefficient c,
//     acc = sum over j < ds of t[i][j][c] * key[j][k][key_idx(i)][c]
//   in 128 bits, wrapping mod 2^128 like limb.add128, then acc mod q_i
//   exactly: the high and low words are each reduced by Barrett and folded
//   with 2^64 mod q_i. key_idx(i) is i, or kms - 1 for the key prime's row
//   i = ds, so below the top level (kms > ds + 1) the key prime's row is
//   the keys' last. The wrap bound: t < 4 q_i (the (4, 4) forward
//   transforms' range; the target itself < q_i) and keys < q_i, so
//   acc < ds * 4 q_i * q_i, which stays below 2^128 while
//   ds * 4 q_i^2 < 2^128: for rows below 2^60 any ds < 64, and SEAL's
//   {60, 40 x 19, 60} chain at ds 20 reaches 2^126.33, a factor of 3.2
//   below the wrap. Above the bound the sum wraps as the JAX package's
//   does. The JAX package has a stacked form (one static Barrett shift
//   for rows of one bit length) and a per-(i, k) loop; both are fully
//   reduced, so one launch with per-row constants (q, q_barr, 2^64 mod q,
//   mu, shift in `consts`, (5, rns)) serves every basis.
// - K11 spread (:226-252): the key prime's row after its (2,2) inverse NTT,
//   plus floor(qk/2) and reduced mod qk, then reduced mod each q_i where
//   qk > q_i, plus (q_i - floor(qk/2) mod q_i): (kc, n) -> (ds, kc, n), in
//   [0, 2 q_i), the input of the mod-down's forward NTTs.
// - K11 fold (:272-284): out = add_mod(result, fma_mod(tpp + 4 q_i - tntt,
//   qk^-1 mod q_i, IMF 8)), with the scalar and its Shoup precondition per
//   row.
// Every output is bit-identical to the plain versions in
// experimental/key_switch.py.
//
// What bounds them on an H100: K10 reads ds words of t and kc*ds key words
// and writes kc words per coefficient of a row (8(ds + 2 ds + 2) bytes at
// kc = 2), against ds 64x64 high and low products per output word plus
// the flush's three Barrett steps: at the card's rates it is bound by
// bytes. K11 moves 16-32 bytes per output word against one or two
// products: bytes.
//
// K10's design: the grid is (coefficient blocks, rns, component groups),
// and a thread takes two neighbouring coefficients of its row for every
// key component of its group at once, so each word of t is read once a
// group (a grid row per (row, component) pair read t kc times; on an H100
// its second read came from the L2, and the kernel sat at 73% of its
// bytes bound for want of bytes in flight). A group holds at most
// MAC_GROUP components, its size G a template parameter (1 to MAC_GROUP):
// the G (hi, lo) accumulator pairs of both coefficients stay in
// registers, with an explicit carry. Any kc runs as kc / MAC_GROUP full
// groups on the grid's z axis, then one launch for the kc % MAC_GROUP
// left, the real kc the stride of the keys and the output (the callers
// pass kc = 2: one group, one launch). t and the key rows are read 16
// bytes at a time, marked as touched once (__ldcs), and the j loop runs in
// groups of MAC_J trips whose loads are all issued before the group's
// multiply-accumulates, so several trips' loads are in flight ahead of
// the dependent adds. Where a row of t, of
// the keys or of the output is not 16-byte aligned, or n is odd (keys come
// from the caller, and a view may start 8 bytes off), the kernel reads and
// writes every word singly instead, a branch it takes once. A CTA of 128
// threads for every 128 pairs of a row: at the key switch's shapes that
// timed better than 256 threads and than one full wave of CTAs striding
// (chip_smoke.py --stream-variants). K11: a grid row per (row, component)
// pair; neighbouring threads take neighbouring coefficients.
//
// Each kernel is a template on A, the approximate quotients the JAX
// package takes where its config.approx_butterflies() is on: in K10 the
// two 64-bit Barrett reductions (barrett_reduce_approx) and the fold
// (mult_mod_barrett_approx) of _barrett_reduce_128 (key_switch.py:34-51;
// its stacked form _barrett_reduce_128_rows stays exact, and the caller
// picks A by that rule); in K11's spread the +qk/2 Barrett and the reduce
// to q_i (:236-247), in its fold the Shoup product of fma_mod at IMF 8
// (shoup_approx, jnp_kernels.py:110-111). Every output is fully reduced,
// so both forms give the same bits.
#include "grid.cuh"
#include "modarith.cuh"

// K11's grid: x over coefficients (grid-stride, at most 8 CTAs of 256 an
// SM over all rows), y over rows.
static int grid_x(long long n, int rows, unsigned* out) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(device);
  if (!sms) return (int)cudaErrorInvalidDevice;
  const long long needed = (n + 255) / 256;
  long long cap = (long long)sms * 8 / rows;
  if (cap < 1) cap = 1;
  *out = (unsigned)(needed < cap ? needed : cap);
  return 0;
}

constexpr int MAC_THREADS = 128;
constexpr int MAC_J = 4;   // j trips whose loads are issued together

// The largest group of components (experimental/key_switch.py
// MAC_GROUP); K10 is instantiated for every group size up to it.
constexpr int MAC_GROUP = 4;

// Coefficients 2p and 2p + 1 of a row, marked as touched once
// (evict-first): one 16-byte load where VEC, else two 8-byte ones (the
// second only where 2p + 1 < n).
template <bool VEC>
__device__ __forceinline__ ulonglong2 mac_pair(const u64* __restrict__ row,
                                               long long p, long long n) {
  if constexpr (VEC)
    return __ldcs(reinterpret_cast<const ulonglong2*>(row) + p);
  else
    return make_ulonglong2(__ldcs(row + 2 * p),
                           2 * p + 1 < n ? __ldcs(row + 2 * p + 1) : 0);
}

// (hi, lo) += a * b in 128 bits, wrapping.
__device__ __forceinline__ void mac(u64& hi, u64& lo, u64 a, u64 b) {
  const u64 p_lo = a * b;
  lo += p_lo;
  hi += __umul64hi(a, b) + (lo < p_lo ? 1 : 0);
}

// The MAC and flush of row i's coefficient pair p for the KC components
// of a group (krow and orow at its first) of kc; VEC: every row 16-byte
// aligned and n even.
template <bool A, int KC, bool VEC>
__device__ __forceinline__ void mac_flush_pair(
    const u64* __restrict__ trow, const u64* __restrict__ krow,
    u64* __restrict__ orow, int ds, int kc, int kms, long long n, u64 q,
    u64 q_barr, u64 r_mod, u64 mu, int shift, long long p) {
  const long long key_stride = (long long)kc * kms * n;   // next j
  const long long comp_stride = (long long)kms * n;       // next component
  u64 hi[KC][2], lo[KC][2];
#pragma unroll
  for (int k = 0; k < KC; ++k) hi[k][0] = hi[k][1] = lo[k][0] = lo[k][1] = 0;
  for (int j0 = 0; j0 < ds; j0 += MAC_J) {
    ulonglong2 tv[MAC_J], kv[MAC_J][KC];
#pragma unroll
    for (int u = 0; u < MAC_J; ++u) {
      if (j0 + u < ds) {
        tv[u] = mac_pair<VEC>(trow + (long long)(j0 + u) * n, p, n);
#pragma unroll
        for (int k = 0; k < KC; ++k)
          kv[u][k] = mac_pair<VEC>(
              krow + (j0 + u) * key_stride + k * comp_stride, p, n);
      }
    }
#pragma unroll
    for (int u = 0; u < MAC_J; ++u) {
      if (j0 + u < ds) {
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          mac(hi[k][0], lo[k][0], tv[u].x, kv[u][k].x);
          mac(hi[k][1], lo[k][1], tv[u].y, kv[u][k].y);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    u64 r[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const u64 hi_red = barrett_reduce_q<A>(hi[k][e], q, q_barr, 1);
      const u64 lo_red = barrett_reduce_q<A>(lo[k][e], q, q_barr, 1);
      const u64 folded = mult_mod_barrett_q<A>(hi_red, r_mod, q, mu, shift);
      r[e] = halve(folded + lo_red, q);
    }
    u64* o = orow + k * n;
    if constexpr (VEC) {
      reinterpret_cast<ulonglong2*>(o)[p] = make_ulonglong2(r[0], r[1]);
    } else {
      o[2 * p] = r[0];
      if (2 * p + 1 < n) o[2 * p + 1] = r[1];
    }
  }
}

// Row blockIdx.y, components k0 + KC blockIdx.z .. + KC - 1 of kc.
template <bool A, int KC>
__global__ void __launch_bounds__(MAC_THREADS)
    mac_flush_kernel(const u64* __restrict__ t, const u64* __restrict__ keys,
                     u64* __restrict__ out, const u64* __restrict__ consts,
                     int rns, int ds, int kc, int kms, long long n, int k0) {
  const int i = blockIdx.y;
  const int key_idx = i == ds ? kms - 1 : i;
  const long long k = k0 + (long long)KC * blockIdx.z;
  const u64 q = consts[i], q_barr = consts[rns + i];
  const u64 r_mod = consts[2 * rns + i], mu = consts[3 * rns + i];
  const int shift = (int)consts[4 * rns + i];
  const u64* trow = t + (long long)i * ds * n;
  const u64* krow = keys + (k * kms + key_idx) * n;
  u64* orow = out + ((long long)i * kc + k) * n;
  const long long p = (long long)blockIdx.x * MAC_THREADS + threadIdx.x;
  if (p >= (n + 1) / 2) return;
  // Every row starts at a multiple of n words from its base.
  if (n % 2 == 0 && ((uintptr_t)t & 15) == 0 && ((uintptr_t)keys & 15) == 0 &&
      ((uintptr_t)out & 15) == 0)
    mac_flush_pair<A, KC, true>(trow, krow, orow, ds, kc, kms, n, q, q_barr,
                                r_mod, mu, shift, p);
  else
    mac_flush_pair<A, KC, false>(trow, krow, orow, ds, kc, kms, n, q, q_barr,
                                 r_mod, mu, shift, p);
}

// `groups` groups of KC components from k0: a CTA for every MAC_THREADS
// pairs of a row (a pair a thread), rns rows.
template <bool A, int KC>
static int launch_mac(const u64* t, const u64* keys, u64* out,
                      const u64* consts, int rns, int ds, int kc, int kms,
                      long long n, int k0, int groups, cudaStream_t stream) {
  const long long gx = ((n + 1) / 2 + MAC_THREADS - 1) / MAC_THREADS;
  mac_flush_kernel<A, KC><<<dim3((unsigned)gx, rns, groups), MAC_THREADS, 0, stream>>>(t, keys, out, consts, rns, ds, kc, kms, n, k0);
  return (int)cudaGetLastError();
}

// kc / MAC_GROUP groups of MAC_GROUP components, then the kc % MAC_GROUP
// left in one group.
template <bool A>
static int launch_mac_groups(const u64* t, const u64* keys, u64* out,
                             const u64* consts, int rns, int ds, int kc,
                             int kms, long long n, cudaStream_t stream) {
  const int full = kc / MAC_GROUP, left = kc % MAC_GROUP;
  if (full) {
    const int err = launch_mac<A, MAC_GROUP>(t, keys, out, consts, rns, ds,
                                             kc, kms, n, 0, full, stream);
    if (err) return err;
  }
  const int k0 = full * MAC_GROUP;
  switch (left) {
    case 1: return launch_mac<A, 1>(t, keys, out, consts, rns, ds, kc, kms,
                                    n, k0, 1, stream);
    case 2: return launch_mac<A, 2>(t, keys, out, consts, rns, ds, kc, kms,
                                    n, k0, 1, stream);
    case 3: return launch_mac<A, 3>(t, keys, out, consts, rns, ds, kc, kms,
                                    n, k0, 1, stream);
    default: return 0;
  }
}

// x (kc, n) -> out (ds, kc, n); consts (3, ds): q_i, q_barr_i, fix_i.
template <bool A>
__global__ void spread_kernel(const u64* __restrict__ x,
                              u64* __restrict__ out,
                              const u64* __restrict__ consts, u64 qk,
                              u64 qk_barr, u64 qk_half, int ds,
                              long long count) {
  const int i = blockIdx.y;
  const u64 q = consts[i], q_barr = consts[ds + i], fix = consts[2 * ds + i];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < count; e += stride) {
    const u64 v = barrett_reduce_q<A>(x[e] + qk_half, qk, qk_barr, 1);
    const u64 r = qk > q && v >= q ? barrett_reduce_q<A>(v, q, q_barr, 1) : v;
    out[(long long)i * count + e] = r + fix;
  }
}

// result (kc, ds, n), tpp (>= ds rows, kc, n), tntt (ds, kc, n) -> out
// (kc, ds, n); consts (3, ds): q_i, w_i, w_precon_i.
template <bool A>
__global__ void fold_kernel(const u64* __restrict__ result,
                            const u64* __restrict__ tpp,
                            const u64* __restrict__ tntt,
                            u64* __restrict__ out,
                            const u64* __restrict__ consts, int ds, int kc,
                            long long n) {
  const int k = blockIdx.y / ds, i = blockIdx.y % ds;
  const u64 q = consts[i], w = consts[ds + i], wp = consts[2 * ds + i];
  const long long src = ((long long)i * kc + k) * n;
  const long long dst = ((long long)k * ds + i) * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < n; c += stride) {
    const u64 x = reduce_lazy8(tpp[src + c] + 4 * q - tntt[src + c], q, 8);
    const u64 prod = halve(A ? shoup_approx(x, w, wp, q) : shoup(x, w, wp, q),
                           q);
    out[dst + c] = halve(result[dst + c] + prod, q);
  }
}

// Each entry's approx: 0 for the exact quotients, 1 for the approximate
// ones.
extern "C" int hexl_ks_mac_flush(const u64* t, const u64* keys, u64* out,
                                 const u64* consts, int rns, int ds, int kc,
                                 int kms, long long n, int approx,
                                 cudaStream_t stream) {
  if (rns < 1 || rns > 65535 || ds < 1 || kc < 1 ||
      kc / MAC_GROUP > 65535 || n < 1)
    return (int)cudaErrorInvalidValue;
  return approx ? launch_mac_groups<true>(t, keys, out, consts, rns, ds, kc,
                                          kms, n, stream)
                : launch_mac_groups<false>(t, keys, out, consts, rns, ds, kc,
                                           kms, n, stream);
}

extern "C" int hexl_ks_spread(const u64* x, u64* out, const u64* consts,
                              u64 qk, u64 qk_barr, u64 qk_half, int ds,
                              long long count, int approx,
                              cudaStream_t stream) {
  unsigned gx = 0;
  const int err = grid_x(count, ds, &gx);
  if (err) return err;
  if (approx)
    spread_kernel<true><<<dim3(gx, ds), 256, 0, stream>>>(
        x, out, consts, qk, qk_barr, qk_half, ds, count);
  else
    spread_kernel<false><<<dim3(gx, ds), 256, 0, stream>>>(
        x, out, consts, qk, qk_barr, qk_half, ds, count);
  return (int)cudaGetLastError();
}

extern "C" int hexl_ks_fold(const u64* result, const u64* tpp,
                            const u64* tntt, u64* out, const u64* consts,
                            int ds, int kc, long long n, int approx,
                            cudaStream_t stream) {
  unsigned gx = 0;
  const int err = grid_x(n, ds * kc, &gx);
  if (err) return err;
  if (approx)
    fold_kernel<true><<<dim3(gx, ds * kc), 256, 0, stream>>>(
        result, tpp, tntt, out, consts, ds, kc, n);
  else
    fold_kernel<false><<<dim3(gx, ds * kc), 256, 0, stream>>>(
        result, tpp, tntt, out, consts, ds, kc, n);
  return (int)cudaGetLastError();
}
