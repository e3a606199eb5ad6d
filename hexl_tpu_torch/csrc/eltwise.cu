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
template <typename W>
struct MultMod;

template <>
struct MultMod<u64> {
  __device__ u64 operator()(const u64* a, const u64* b, const u64*,
                            long long i, const Scalars& s) const {
    return mult_mod_barrett(reduce_lazy(a[i], s.q, s.i1),
                            reduce_lazy(b[i], s.q, s.i1), s.q, s.s0, s.i0);
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
template <typename W>
struct FmaMod {
  __device__ u64 operator()(const u64* a, const u64*, const u64* c,
                            long long i, const Scalars& s) const {
    const W q = (W)s.q;
    const W x = reduce_lazy8((W)a[i], q, s.i1);
    const W prod = halve(shoup(x, (W)s.s0, (W)s.s1, q), q);
    if (!c) return prod;
    return halve((W)(prod + reduce_lazy8((W)c[i], q, s.i1)), q);
  }
};

// The full reduction of reduce_mod at imf == q: in u64, Barrett with
// q_barr = s0 where x >= q; in u32, the single-word Barrett product with
// mu = s0 and shift = s1, as jnp_kernels32.reduce_mod32 computes it.
__device__ __forceinline__ u64 reduce_full(u64 x, const Scalars& s) {
  return x >= s.q ? barrett_reduce(x, s.q, s.s0, s.i1) : x;
}

__device__ __forceinline__ u32 reduce_full(u32 x, const Scalars& s) {
  const u32 z = barrett_prod32(0, x, (u32)s.q, (u32)s.s0, (int)s.s1);
  return s.i1 == 1 ? halve(z, (u32)s.q) : z;
}

// The range change: mode i0 = 0 (imf == omf: unchanged), 1 (imf == q),
// 2 or 4 (the imf); omf = i1.
template <typename W>
struct ReduceMod {
  __device__ u64 operator()(const u64* a, const u64*, const u64*,
                            long long i, const Scalars& s) const {
    const W x = (W)a[i];
    const W q = (W)s.q;
    switch (s.i0) {
      case 0: return x;
      case 1: return reduce_full(x, s);
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
struct CmpSubMod {
  __device__ u64 operator()(const u64* a, const u64*, const u64*,
                            long long i, const Scalars& s) const {
    const u64 x = a[i];
    const u64 red = barrett_reduce(x, s.q, s.s2, 1);
    return compare(x, s.s0, s.i0) ? halve(red - s.s1 + s.q, s.q) : red;
  }
};

// Montgomery form in (a * (2^64 mod q) mod q: mu = s0, 2^64 mod q = s1,
// shift = i0), out (REDC(0:a), inv = s0) and mult_reduce (REDC(a*b)).
struct MontIn {
  __device__ u64 operator()(const u64* a, const u64*, const u64*,
                            long long i, const Scalars& s) const {
    return mult_mod_barrett(a[i], s.s1, s.q, s.s0, s.i0);
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

// out[i] = op(a[i], b[i], c[i]) for i < count; b and c may be null where
// the op takes a scalar or no operand. word is 64 or 32 (ops 0-4 only).
extern "C" int hexl_eltwise(const u64* a, const u64* b, const u64* c,
                            u64* out, long long count, int op, int word,
                            u64 q, u64 s0, u64 s1, u64 s2, int i0, int i1,
                            cudaStream_t stream) {
  const Scalars s = {q, s0, s1, s2, i0, i1};
  if (word == 32) return launch_word<u32>(op, a, b, c, out, count, s, stream);
  switch (op) {
    case OP_CMP_ADD: return launch(CmpAdd{}, a, b, c, out, count, s, stream);
    case OP_CMP_SUB: return launch(CmpSubMod{}, a, b, c, out, count, s,
                                   stream);
    case OP_MONT_IN: return launch(MontIn{}, a, b, c, out, count, s, stream);
    case OP_MONT_OUT: return launch(MontOut{}, a, b, c, out, count, s,
                                    stream);
    case OP_MONT_MULT: return launch(MontMult{}, a, b, c, out, count, s,
                                     stream);
    default: return launch_word<u64>(op, a, b, c, out, count, s, stream);
  }
}
