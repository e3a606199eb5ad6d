// K4 and K8: the element-wise family, one grid-stride kernel template.
//
// Replaces the TPU kernel hexl_tpu/eltwise/pallas_kernels.py::run_eltwise,
// a generic runner that applies any element-wise body over zero-padded
// (512, 128) VMEM blocks. Here each body is an op functor and
// eltwise_kernel runs it over a flat array: K4 is the mult_mod body, K8
// every other one (add/sub with a vector or a scalar, fma with and
// without the addend, reduce, cmp_add, cmp_sub_mod, and the Montgomery
// family with R = 2^64). The functors are templates on the word W: u64
// for every modulus, u32 for the single-word bodies of q < 2^30 (the low
// words of the operands, a zero high word in the result), as in
// hexl_tpu/eltwise/jnp_kernels32.py. Scalars are kernel arguments. Every
// body is bit-identical to its plain version (eltwise/torch_kernels.py,
// torch_kernels32.py), lazy ranges included; compares are unsigned.
//
// The five 64-bit bodies that hexl_tpu/eltwise/jnp_kernels.py switches to
// approximate quotients (_approx(): mult_mod, fma_mod, reduce_mod,
// cmp_sub_mod, montgomery_form_in) are also instantiated with that
// quotient (mulhi64_approx, error at most 1, modarith.cuh): a compile-time
// flag A of their functors, picked at launch by the C entries' `approx`
// argument, so that neither form carries the other's branch.
//
// What bounds it on an H100: 16-32 bytes per element (one to three
// operands read, one written) against at most two 64x64 high and two low
// products; at the card's rates every body is bound by bytes. The design
// reads each operand once and writes each output once, neighbouring
// threads on neighbouring elements, with no padding copies, and loads an
// operand only where its body reads it.
#include "modarith.cuh"

enum Op {
  OP_ADD = 0,
  OP_SUB = 1,
  OP_MULT = 2,
  OP_FMA = 3,
  OP_REDUCE = 4,
  OP_CMP_ADD = 5,
  OP_CMP_SUB = 6,
  OP_MONT_IN = 7,
  OP_MONT_OUT = 8,
  OP_MONT_MULT = 9,
};

// The kernel's scalar arguments; each op reads the ones it names.
struct Scalars {
  u64 q, s0, s1, s2;
  int i0, i1;
};

// The CMPINT predicates, unsigned: EQ, LT, LE, FALSE, NE, NLT, NLE, TRUE.
__device__ __forceinline__ bool compare(u64 a, u64 bound, int cmp) {
  switch (cmp) {
    case 0: return a == bound;
    case 1: return a < bound;
    case 2: return a <= bound;
    case 3: return false;
    case 4: return a != bound;
    case 5: return a >= bound;
    case 6: return a > bound;
    default: return true;
  }
}

// REDC of the 128-bit value (hi, lo) with q * inv = -1 mod 2^64.
__device__ __forceinline__ u64 montgomery_reduce(u64 hi, u64 lo, u64 q,
                                                 u64 inv) {
  const u64 m = lo * inv;
  const u64 mq_lo = m * q;
  const u64 mq_hi = __umul64hi(m, q);
  const u64 carry = lo + mq_lo < lo ? 1 : 0;
  return halve(hi + mq_hi + carry, q);
}

// The single-word Barrett product of a 2n-bit value (hi:lo in 32-bit
// words) with mu = floor(2^(n+30) / q): [0, 2q).
__device__ __forceinline__ u32 barrett_prod32(u32 hi, u32 lo, u32 q, u32 mu,
                                              int shift) {
  const u32 c1 = shift == 0 ? lo
                 : shift < 32 ? (lo >> shift) | (hi << (32 - shift))
                              : hi >> (shift - 32);
  const u32 z = lo - __umulhi(c1, mu) * q;
  return halve(z, 2 * q);
}

// (a + b) mod q; b a vector, or the scalar s0 when b is null.
template <typename W>
struct AddSub {
  bool sub;
  __device__ u64 operator()(const u64* a, const u64* b, const u64*,
                            long long i, const Scalars& s) const {
    const W q = (W)s.q;
    const W x = (W)a[i];
    const W y = (W)(b ? b[i] : s.s0);
    return halve(sub ? (W)(x - y + q) : (W)(x + y), q);
  }
};

// (a * b) mod q at imf 1/2/4: mu = s0, shift = i0, imf = i1.
template <typename W, bool A = false>
struct MultMod;

template <bool A>
struct MultMod<u64, A> {
  __device__ u64 operator()(const u64* a, const u64* b, const u64*,
                            long long i, const Scalars& s) const {
    return mult_mod_barrett_q<A>(reduce_lazy(a[i], s.q, s.i1),
                                 reduce_lazy(b[i], s.q, s.i1), s.q, s.s0,
                                 s.i0);
  }
};

template <>
struct MultMod<u32> {
  __device__ u64 operator()(const u64* a, const u64* b, const u64*,
                            long long i, const Scalars& s) const {
    const u32 q = (u32)s.q;
    const u32 x = reduce_lazy((u32)a[i], q, s.i1);
    const u32 y = reduce_lazy((u32)b[i], q, s.i1);
    const u32 z = barrett_prod32(__umulhi(x, y), x * y, q, (u32)s.s0, s.i0);
    return halve(z, q);
  }
};

// (a * w + c) mod q at imf 1/2/4/8: w = s0, its precondition s1 (at 2^64
// for u64, 2^32 for u32), imf = i1; no addend when c is null.
template <typename W, bool A = false>
struct FmaMod {
  __device__ u64 operator()(const u64* a, const u64*, const u64* c,
                            long long i, const Scalars& s) const {
    const W q = (W)s.q;
    const W x = reduce_lazy8((W)a[i], q, s.i1);
    W lazy;
    if constexpr (A)
      lazy = shoup_approx(x, (W)s.s0, (W)s.s1, q);
    else
      lazy = shoup(x, (W)s.s0, (W)s.s1, q);
    const W prod = halve(lazy, q);
    if (!c) return prod;
    return halve((W)(prod + reduce_lazy8((W)c[i], q, s.i1)), q);
  }
};

// The full reduction of reduce_mod at imf == q: in u64, Barrett with
// q_barr = s0 where x >= q; in u32, the single-word Barrett product with
// mu = s0 and shift = s1, as jnp_kernels32.reduce_mod32 computes it.
template <bool A>
__device__ __forceinline__ u64 reduce_full(u64 x, const Scalars& s) {
  return x >= s.q ? barrett_reduce_q<A>(x, s.q, s.s0, s.i1) : x;
}

template <bool A>
__device__ __forceinline__ u32 reduce_full(u32 x, const Scalars& s) {
  const u32 z = barrett_prod32(0, x, (u32)s.q, (u32)s.s0, (int)s.s1);
  return s.i1 == 1 ? halve(z, (u32)s.q) : z;
}

// The range change: mode i0 = 0 (imf == omf: unchanged), 1 (imf == q),
// 2 or 4 (the imf); omf = i1.
template <typename W, bool A = false>
struct ReduceMod {
  __device__ u64 operator()(const u64* a, const u64*, const u64*,
                            long long i, const Scalars& s) const {
    const W x = (W)a[i];
    const W q = (W)s.q;
    switch (s.i0) {
      case 0: return x;
      case 1: return reduce_full<A>(x, s);
      case 2: return halve(x, q);
      default: {
        const W z = halve(x, (W)(2 * q));
        return s.i1 == 1 ? halve(z, q) : z;
      }
    }
  }
};

// cmp(a, bound) ? a + diff : a: bound = s0, diff = s1, cmp = i0.
struct CmpAdd {
  __device__ u64 operator()(const u64* a, const u64*, const u64*,
                            long long i, const Scalars& s) const {
    const u64 x = a[i];
    return compare(x, s.s0, s.i0) ? x + s.s1 : x;
  }
};

// cmp(a, bound) ? (a mod q - diff) mod q : a mod q: bound = s0, diff = s1,
// q_barr = s2, cmp = i0.
template <bool A = false>
struct CmpSubMod {
  __device__ u64 operator()(const u64* a, const u64*, const u64*,
                            long long i, const Scalars& s) const {
    const u64 x = a[i];
    const u64 red = barrett_reduce_q<A>(x, s.q, s.s2, 1);
    return compare(x, s.s0, s.i0) ? halve(red - s.s1 + s.q, s.q) : red;
  }
};

// Montgomery form in (a * (2^64 mod q) mod q: mu = s0, 2^64 mod q = s1,
// shift = i0), out (REDC(0:a), inv = s0) and mult_reduce (REDC(a*b)).
template <bool A = false>
struct MontIn {
  __device__ u64 operator()(const u64* a, const u64*, const u64*,
                            long long i, const Scalars& s) const {
    return mult_mod_barrett_q<A>(a[i], s.s1, s.q, s.s0, s.i0);
  }
};

struct MontOut {
  __device__ u64 operator()(const u64* a, const u64*, const u64*,
                            long long i, const Scalars& s) const {
    return montgomery_reduce(0, a[i], s.q, s.s0);
  }
};

struct MontMult {
  __device__ u64 operator()(const u64* a, const u64* b, const u64*,
                            long long i, const Scalars& s) const {
    const u64 x = a[i], y = b[i];
    return montgomery_reduce(__umul64hi(x, y), x * y, s.q, s.s0);
  }
};

template <typename F>
__global__ void eltwise_kernel(F f, const u64* __restrict__ a,
                               const u64* __restrict__ b,
                               const u64* __restrict__ c,
                               u64* __restrict__ out, long long count,
                               Scalars s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    out[i] = f(a, b, c, i, s);
  }
}

template <typename F>
static int launch(F f, const u64* a, const u64* b, const u64* c, u64* out,
                  long long count, const Scalars& s, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long needed = (count + threads - 1) / threads;
  const long long cap = (long long)sms * 8;
  const int blocks = (int)(needed < cap ? needed : cap);
  eltwise_kernel<<<blocks, threads, 0, stream>>>(f, a, b, c, out, count, s);
  return (int)cudaGetLastError();
}

template <typename W>
static int launch_word(int op, const u64* a, const u64* b, const u64* c,
                       u64* out, long long count, const Scalars& s,
                       cudaStream_t stream) {
  switch (op) {
    case OP_ADD: return launch(AddSub<W>{false}, a, b, c, out, count, s,
                               stream);
    case OP_SUB: return launch(AddSub<W>{true}, a, b, c, out, count, s,
                               stream);
    case OP_MULT: return launch(MultMod<W>{}, a, b, c, out, count, s, stream);
    case OP_FMA: return launch(FmaMod<W>{}, a, b, c, out, count, s, stream);
    case OP_REDUCE: return launch(ReduceMod<W>{}, a, b, c, out, count, s,
                                  stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The approximate-quotient instantiations: the five 64-bit ops of
// jnp_kernels._approx().
static int launch_approx(int op, const u64* a, const u64* b, const u64* c,
                         u64* out, long long count, const Scalars& s,
                         cudaStream_t stream) {
  switch (op) {
    case OP_MULT: return launch(MultMod<u64, true>{}, a, b, c, out, count, s,
                                stream);
    case OP_FMA: return launch(FmaMod<u64, true>{}, a, b, c, out, count, s,
                               stream);
    case OP_REDUCE: return launch(ReduceMod<u64, true>{}, a, b, c, out,
                                  count, s, stream);
    case OP_CMP_SUB: return launch(CmpSubMod<true>{}, a, b, c, out, count, s,
                                   stream);
    case OP_MONT_IN: return launch(MontIn<true>{}, a, b, c, out, count, s,
                                   stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[i] = op(a[i], b[i], c[i]) for i < count; b and c may be null where
// the op takes a scalar or no operand. word is 64 or 32 (ops 0-4 only);
// approx (word 64, ops 2, 3, 4, 6 and 7) takes the approximate quotient.
extern "C" int hexl_eltwise(const u64* a, const u64* b, const u64* c,
                            u64* out, long long count, int op, int word,
                            int approx, u64 q, u64 s0, u64 s1, u64 s2,
                            int i0, int i1, cudaStream_t stream) {
  const Scalars s = {q, s0, s1, s2, i0, i1};
  if (approx) {
    if (word != 64) return (int)cudaErrorInvalidValue;
    return launch_approx(op, a, b, c, out, count, s, stream);
  }
  if (word == 32) return launch_word<u32>(op, a, b, c, out, count, s, stream);
  switch (op) {
    case OP_CMP_ADD: return launch(CmpAdd{}, a, b, c, out, count, s, stream);
    case OP_CMP_SUB: return launch(CmpSubMod<>{}, a, b, c, out, count, s,
                                   stream);
    case OP_MONT_IN: return launch(MontIn<>{}, a, b, c, out, count, s,
                                   stream);
    case OP_MONT_OUT: return launch(MontOut{}, a, b, c, out, count, s,
                                    stream);
    case OP_MONT_MULT: return launch(MontMult{}, a, b, c, out, count, s,
                                     stream);
    default: return launch_word<u64>(op, a, b, c, out, count, s, stream);
  }
}

// -- K4.rows and K8.reduce.rows: one op over the k rows of a (k, m) block ---
//
// The RNS basis's moduli in one launch, each row under its own modulus, as
// K9 takes per-row constants (dyadic.cu): row r of `consts` (k, 4) holds
// q_r, mu_r and shift_r of the single-mulhi Barrett product and
// q_barr_r = floor(2^64 / q_r). Two ops take rows: mult_mod at an IMF (the
// RNS product's pointwise step, hexl_tpu/poly.py:159-161) and reduce_mod
// from IMF = q to OMF `factor` (the key switch's base conversion,
// hexl_tpu/experimental/key_switch.py:140-144); the bodies are the
// functors above, so each row is bit-identical to the single-modulus op.
// The grid is (CTAs a row, k): a CTA reads its row's constants once.
template <typename F>
__global__ void eltwise_rows_kernel(F f, const u64* __restrict__ a,
                                    const u64* __restrict__ b,
                                    u64* __restrict__ out,
                                    const u64* __restrict__ consts,
                                    long long m, int op, int factor) {
  const u64* c = consts + 4 * blockIdx.y;
  const Scalars s = op == OP_MULT
                        ? Scalars{c[0], c[1], 0, 0, (int)c[2], factor}
                        : Scalars{c[0], c[3], 0, 0, 1, factor};
  const long long off = (long long)blockIdx.y * m;
  const u64* ra = a + off;
  const u64* rb = b ? b + off : nullptr;
  u64* ro = out + off;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    ro[i] = f(ra, rb, nullptr, i, s);
  }
}

// out[r][i] = op(a[r][i], b[r][i]) under row r's modulus, for r < k and
// i < m: op 2 (mult_mod, factor = the IMF) or 4 (reduce_mod from IMF = q
// to OMF factor), 64-bit; approx takes the approximate quotient.
extern "C" int hexl_eltwise_rows(const u64* a, const u64* b, u64* out,
                                 const u64* consts, int k, long long m,
                                 int op, int factor, int approx,
                                 cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 65535 || m < 1 || (op != OP_MULT && op != OP_REDUCE))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long needed = (m + threads - 1) / threads;
  long long cap = (long long)sms * 8 / k;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(needed < cap ? needed : cap), (unsigned)k);
  if (op == OP_MULT && approx)
    eltwise_rows_kernel<<<grid, threads, 0, stream>>>(MultMod<u64, true>{}, a, b, out, consts, m, op, factor);
  else if (op == OP_MULT)
    eltwise_rows_kernel<<<grid, threads, 0, stream>>>(MultMod<u64>{}, a, b, out, consts, m, op, factor);
  else if (approx)
    eltwise_rows_kernel<<<grid, threads, 0, stream>>>(ReduceMod<u64, true>{}, a, b, out, consts, m, op, factor);
  else
    eltwise_rows_kernel<<<grid, threads, 0, stream>>>(ReduceMod<u64>{}, a, b, out, consts, m, op, factor);
  return (int)cudaGetLastError();
}
