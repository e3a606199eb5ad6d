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
//   i = ds. The JAX package has a stacked form (one static Barrett shift
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
// products: bytes. The design gives every (row, component) pair a grid row,
// so a thread reads its row's constants once; the 128-bit sum stays in two
// registers with an explicit carry; neighbouring threads take neighbouring
// coefficients.
#include "modarith.cuh"

// Grid: x over coefficients (grid-stride), y over rows.
static int grid_x(long long n, int rows, unsigned* out) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long needed = (n + 255) / 256;
  long long cap = (long long)sms * 8 / rows;
  if (cap < 1) cap = 1;
  *out = (unsigned)(needed < cap ? needed : cap);
  return 0;
}

__global__ void mac_flush_kernel(const u64* __restrict__ t,
                                 const u64* __restrict__ keys,
                                 u64* __restrict__ out,
                                 const u64* __restrict__ consts, int rns,
                                 int ds, int kc, int kms, long long n) {
  const int i = blockIdx.y / kc, k = blockIdx.y % kc;
  const int key_idx = i == ds ? kms - 1 : i;
  const u64 q = consts[i], q_barr = consts[rns + i];
  const u64 r_mod = consts[2 * rns + i], mu = consts[3 * rns + i];
  const int shift = (int)consts[4 * rns + i];
  const u64* trow = t + (long long)i * ds * n;
  const u64* krow = keys + ((long long)k * kms + key_idx) * n;
  const long long key_stride = (long long)kc * kms * n;   // next j
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < n; c += stride) {
    u64 hi = 0, lo = 0;
    for (int j = 0; j < ds; ++j) {
      const u64 a = trow[(long long)j * n + c];
      const u64 b = krow[j * key_stride + c];
      const u64 p_lo = a * b;
      lo += p_lo;
      hi += __umul64hi(a, b) + (lo < p_lo ? 1 : 0);
    }
    const u64 hi_red = barrett_reduce(hi, q, q_barr, 1);
    const u64 lo_red = barrett_reduce(lo, q, q_barr, 1);
    const u64 folded = mult_mod_barrett(hi_red, r_mod, q, mu, shift);
    out[((long long)i * kc + k) * n + c] = halve(folded + lo_red, q);
  }
}

// x (kc, n) -> out (ds, kc, n); consts (3, ds): q_i, q_barr_i, fix_i.
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
    const u64 v = barrett_reduce(x[e] + qk_half, qk, qk_barr, 1);
    const u64 r = qk > q && v >= q ? barrett_reduce(v, q, q_barr, 1) : v;
    out[(long long)i * count + e] = r + fix;
  }
}

// result (kc, ds, n), tpp (>= ds rows, kc, n), tntt (ds, kc, n) -> out
// (kc, ds, n); consts (3, ds): q_i, w_i, w_precon_i.
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
    const u64 prod = halve(shoup(x, w, wp, q), q);
    out[dst + c] = halve(result[dst + c] + prod, q);
  }
}

extern "C" int hexl_ks_mac_flush(const u64* t, const u64* keys, u64* out,
                                 const u64* consts, int rns, int ds, int kc,
                                 int kms, long long n, cudaStream_t stream) {
  unsigned gx = 0;
  const int err = grid_x(n, rns * kc, &gx);
  if (err) return err;
  mac_flush_kernel<<<dim3(gx, rns * kc), 256, 0, stream>>>(
      t, keys, out, consts, rns, ds, kc, kms, n);
  return (int)cudaGetLastError();
}

extern "C" int hexl_ks_spread(const u64* x, u64* out, const u64* consts,
                              u64 qk, u64 qk_barr, u64 qk_half, int ds,
                              long long count, cudaStream_t stream) {
  unsigned gx = 0;
  const int err = grid_x(count, ds, &gx);
  if (err) return err;
  spread_kernel<<<dim3(gx, ds), 256, 0, stream>>>(x, out, consts, qk, qk_barr,
                                                  qk_half, ds, count);
  return (int)cudaGetLastError();
}

extern "C" int hexl_ks_fold(const u64* result, const u64* tpp,
                            const u64* tntt, u64* out, const u64* consts,
                            int ds, int kc, long long n,
                            cudaStream_t stream) {
  unsigned gx = 0;
  const int err = grid_x(n, ds * kc, &gx);
  if (err) return err;
  fold_kernel<<<dim3(gx, ds * kc), 256, 0, stream>>>(result, tpp, tntt, out,
                                                     consts, ds, kc, n);
  return (int)cudaGetLastError();
}
