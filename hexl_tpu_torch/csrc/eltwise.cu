// K4 and K8: the element-wise family, one streaming kernel template.
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
// products; at the card's rates every body is bound by bytes, so the
// design is about the memory system:
// - Each functor takes values, (x, y, z, scalars) -> result, and says
//   which operands it reads (B, C); the loader reads only those.
// - A thread moves 16 bytes (two elements) per operand per access (loads
//   through the read-only path, __ldg, and plain stores), and issues
//   unroll<F>() such accesses of every operand before any arithmetic runs:
//   four for a body that reads one operand, one for a body that reads
//   two, which keeps those within 32 registers and the SMs full of warps.
//   Either way a full wave holds far more than the ~20 KB an SM that
//   Little's law asks for (3.35 TB/s x ~0.7 us over 132 SMs).
// - Alignment: every pointer is 8-byte aligned, not always 16 (a view
//   such as x[1:], an odd row of a rows block of odd length). A span runs
//   one scalar element first where its output is not 16-byte aligned, the
//   body with 16-byte stores, and one scalar element last where one is
//   left; the body loads 16 bytes at a time where every input shares the
//   output's 16-byte phase, else 8 (a fresh output beside an x[1:] input),
//   which the span decides once.
// - Grid: 128 threads a CTA, min(a CTA for every 128 pairs, the CTAs the
//   card holds at once) (grid.cuh: SMs x occupancy, read once per device
//   and kernel), each thread striding by the grid. A large launch is one
//   full wave with no thin last wave, every thread within one trip of
//   every other; a small one (K4 at 2 x 2^12: 32 CTAs) spreads one pair a
//   thread over as many CTAs as it fills.
// The variants timed on the way (chip_smoke.py --stream-variants, PERF.md):
// loads and stores marked as touched once (__ldcs/__stcs, evict-first),
// one or four accesses for every body, 64- and 256-thread CTAs; each was
// slower on some rows. The evict-first form read faster only while a
// graph's calls wrote one output buffer that stayed in the L2; with every
// call writing a fresh buffer it lost 1-4% on the three-word bodies and
// at K4's launch floor.
#include <stdint.h>

#include "grid.cuh"
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

constexpr int THREADS = 128;
constexpr int UNROLL_ONE_INPUT = 4;    // see unroll() below
constexpr int UNROLL_TWO_INPUTS = 1;

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

// The functors: operator()(a, b, c, scalars) on the element's operands; B
// and C say whether the body reads b and c (the others are passed as 0).

// (a + b) mod q; b the vector operand (VEC) or the scalar s0.
template <typename W, bool VEC>
struct AddSub {
  static constexpr bool B = VEC, C = false;
  bool sub;
  __device__ u64 operator()(u64 a, u64 b, u64, const Scalars& s) const {
    const W q = (W)s.q;
    const W x = (W)a;
    const W y = (W)(VEC ? b : s.s0);
    return halve(sub ? (W)(x - y + q) : (W)(x + y), q);
  }
};

// (a * b) mod q at imf 1/2/4: mu = s0, shift = i0, imf = i1.
template <typename W, bool A = false>
struct MultMod;

template <bool A>
struct MultMod<u64, A> {
  static constexpr bool B = true, C = false;
  __device__ u64 operator()(u64 a, u64 b, u64, const Scalars& s) const {
    return mult_mod_barrett_q<A>(reduce_lazy(a, s.q, s.i1),
                                 reduce_lazy(b, s.q, s.i1), s.q, s.s0, s.i0);
  }
};

template <>
struct MultMod<u32> {
  static constexpr bool B = true, C = false;
  __device__ u64 operator()(u64 a, u64 b, u64, const Scalars& s) const {
    const u32 q = (u32)s.q;
    const u32 x = reduce_lazy((u32)a, q, s.i1);
    const u32 y = reduce_lazy((u32)b, q, s.i1);
    const u32 z = barrett_prod32(__umulhi(x, y), x * y, q, (u32)s.s0, s.i0);
    return halve(z, q);
  }
};

// (a * w + c) mod q at imf 1/2/4/8: w = s0, its precondition s1 (at 2^64
// for u64, 2^32 for u32), imf = i1; the addend c where ADD.
template <typename W, bool A, bool ADD>
struct FmaMod {
  static constexpr bool B = false, C = ADD;
  __device__ u64 operator()(u64 a, u64, u64 c, const Scalars& s) const {
    const W q = (W)s.q;
    const W x = reduce_lazy8((W)a, q, s.i1);
    W lazy;
    if constexpr (A)
      lazy = shoup_approx(x, (W)s.s0, (W)s.s1, q);
    else
      lazy = shoup(x, (W)s.s0, (W)s.s1, q);
    const W prod = halve(lazy, q);
    if constexpr (!ADD) return prod;
    return halve((W)(prod + reduce_lazy8((W)c, q, s.i1)), q);
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
  static constexpr bool B = false, C = false;
  __device__ u64 operator()(u64 a, u64, u64, const Scalars& s) const {
    const W x = (W)a;
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
  static constexpr bool B = false, C = false;
  __device__ u64 operator()(u64 x, u64, u64, const Scalars& s) const {
    return compare(x, s.s0, s.i0) ? x + s.s1 : x;
  }
};

// cmp(a, bound) ? (a mod q - diff) mod q : a mod q: bound = s0, diff = s1,
// q_barr = s2, cmp = i0.
template <bool A = false>
struct CmpSubMod {
  static constexpr bool B = false, C = false;
  __device__ u64 operator()(u64 x, u64, u64, const Scalars& s) const {
    const u64 red = barrett_reduce_q<A>(x, s.q, s.s2, 1);
    return compare(x, s.s0, s.i0) ? halve(red - s.s1 + s.q, s.q) : red;
  }
};

// Montgomery form in (a * (2^64 mod q) mod q: mu = s0, 2^64 mod q = s1,
// shift = i0), out (REDC(0:a), inv = s0) and mult_reduce (REDC(a*b)).
template <bool A = false>
struct MontIn {
  static constexpr bool B = false, C = false;
  __device__ u64 operator()(u64 a, u64, u64, const Scalars& s) const {
    return mult_mod_barrett_q<A>(a, s.s1, s.q, s.s0, s.i0);
  }
};

struct MontOut {
  static constexpr bool B = false, C = false;
  __device__ u64 operator()(u64 a, u64, u64, const Scalars& s) const {
    return montgomery_reduce(0, a, s.q, s.s0);
  }
};

struct MontMult {
  static constexpr bool B = true, C = false;
  __device__ u64 operator()(u64 x, u64 y, u64, const Scalars& s) const {
    return montgomery_reduce(__umul64hi(x, y), x * y, s.q, s.s0);
  }
};

// -- the loader ---------------------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Elements 2p and 2p + 1 of v through the read-only path: one 16-byte
// load where VEC (v 16-byte aligned), else two 8-byte ones.
template <bool VEC>
__device__ __forceinline__ ulonglong2 load_pair(const u64* __restrict__ v,
                                                long long p) {
  if constexpr (VEC)
    return __ldg(reinterpret_cast<const ulonglong2*>(v) + p);
  else
    return make_ulonglong2(__ldg(v + 2 * p), __ldg(v + 2 * p + 1));
}

__device__ __forceinline__ void store_pair(u64* __restrict__ v, long long p,
                                           ulonglong2 x) {
  reinterpret_cast<ulonglong2*>(v)[p] = x;
}

// Element i of a span: f on the operands it reads.
template <typename F>
__device__ __forceinline__ u64 element(const F& f, const u64* __restrict__ a,
                                       const u64* __restrict__ b,
                                       const u64* __restrict__ c, long long i,
                                       const Scalars& s) {
  u64 y = 0, z = 0;
  if constexpr (F::B) y = b[i];
  if constexpr (F::C) z = c[i];
  return f(a[i], y, z, s);
}

// The 16-byte accesses an operand a thread a trip for the body F: four
// for a body that reads one operand (two words an element), one for a
// body that reads two (three words), whose 64-bit products then keep the
// kernel within 32 registers a thread and the SM full of warps (on an
// H100 the heavier three-word bodies lost 4-7% at four accesses, the
// two-word ones gained 2-3% over one: chip_smoke.py --stream-variants).
template <typename F>
__host__ __device__ constexpr int unroll() {
  return F::B || F::C ? UNROLL_TWO_INPUTS : UNROLL_ONE_INPUT;
}

// The 16-byte body of a span: `pairs` pairs into 16-byte aligned `out`,
// CTA `cta` of `ctas` taking pairs tid, tid + threads, ... (tid = cta x
// THREADS + the thread, threads = ctas x THREADS), unroll<F>() of them a
// trip, all loaded before any is computed. The inputs are read 16 bytes
// at a time where VEC (each 16-byte aligned), else 8.
template <typename F, bool VEC>
__device__ __forceinline__ void body(const F& f, const u64* __restrict__ a,
                                     const u64* __restrict__ b,
                                     const u64* __restrict__ c,
                                     u64* __restrict__ out, long long pairs,
                                     const Scalars& s, long long cta,
                                     long long ctas) {
  constexpr int U = unroll<F>();
  const long long threads = ctas * THREADS;
  for (long long p0 = cta * THREADS + threadIdx.x; p0 < pairs;
       p0 += U * threads) {
    ulonglong2 x[U], y[U], z[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long p = p0 + u * threads;
      x[u] = y[u] = z[u] = make_ulonglong2(0, 0);
      if (p < pairs) {
        x[u] = load_pair<VEC>(a, p);
        if constexpr (F::B) y[u] = load_pair<VEC>(b, p);
        if constexpr (F::C) z[u] = load_pair<VEC>(c, p);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long p = p0 + u * threads;
      if (p < pairs)
        store_pair(out, p, make_ulonglong2(f(x[u].x, y[u].x, z[u].x, s),
                                           f(x[u].y, y[u].y, z[u].y, s)));
    }
  }
}

// out[i] = f(a[i], b[i], c[i]) for i < count, by CTA `cta` of `ctas`: a
// scalar head where out is not 16-byte aligned, the 16-byte body, a
// scalar tail where an element is left. The body reads its inputs 16
// bytes at a time where each shares out's 16-byte phase, else 8.
template <typename F>
__device__ __forceinline__ void span(const F& f, const u64* __restrict__ a,
                                     const u64* __restrict__ b,
                                     const u64* __restrict__ c,
                                     u64* __restrict__ out, long long count,
                                     const Scalars& s, long long cta,
                                     long long ctas) {
  const long long head = count > 0 && !aligned16(out) ? 1 : 0;
  const long long pairs = (count - head) / 2;
  const long long tail = head + 2 * pairs;
  if (head && cta == 0 && threadIdx.x == 0)
    out[0] = element(f, a, b, c, 0, s);
  if (tail < count && cta == ctas - 1 && threadIdx.x == THREADS - 1)
    out[tail] = element(f, a, b, c, tail, s);
  a += head;
  if constexpr (F::B) b += head;
  if constexpr (F::C) c += head;
  out += head;
  if (aligned16(a) && (!F::B || aligned16(b)) && (!F::C || aligned16(c)))
    body<F, true>(f, a, b, c, out, pairs, s, cta, ctas);
  else
    body<F, false>(f, a, b, c, out, pairs, s, cta, ctas);
}

template <typename F>
__global__ void __launch_bounds__(THREADS)
    eltwise_kernel(F f, const u64* __restrict__ a, const u64* __restrict__ b,
                   const u64* __restrict__ c, u64* __restrict__ out,
                   long long count, Scalars s) {
  span(f, a, b, c, out, count, s, blockIdx.x, gridDim.x);
}

// CTAs over `pairs` pairs: one pair a thread, at most `cap`, at least one.
static unsigned grid_for(long long pairs, long long cap) {
  const long long needed = (pairs + THREADS - 1) / THREADS;
  const long long blocks = cap < needed ? cap : needed;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <typename F>
static int launch(F f, const u64* a, const u64* b, const u64* c, u64* out,
                  long long count, const Scalars& s, cudaStream_t stream) {
  if ((F::B && !b) || (F::C && !c)) return (int)cudaErrorInvalidValue;
  static ResidentTable table;
  long long cap = 0;
  const int err = resident_ctas(table, eltwise_kernel<F>, THREADS, &cap);
  if (err) return err;
  eltwise_kernel<<<grid_for((count + 1) / 2, cap), THREADS, 0, stream>>>(f, a, b, c, out, count, s);
  return (int)cudaGetLastError();
}

template <typename W, bool A>
static int launch_fma(const u64* a, const u64* c, u64* out, long long count,
                      const Scalars& s, cudaStream_t stream) {
  if (c) return launch(FmaMod<W, A, true>{}, a, nullptr, c, out, count, s,
                       stream);
  return launch(FmaMod<W, A, false>{}, a, nullptr, nullptr, out, count, s,
                stream);
}

template <typename W>
static int launch_add_sub(bool sub, const u64* a, const u64* b, u64* out,
                          long long count, const Scalars& s,
                          cudaStream_t stream) {
  if (b) return launch(AddSub<W, true>{sub}, a, b, nullptr, out, count, s,
                       stream);
  return launch(AddSub<W, false>{sub}, a, nullptr, nullptr, out, count, s,
                stream);
}

template <typename W>
static int launch_word(int op, const u64* a, const u64* b, const u64* c,
                       u64* out, long long count, const Scalars& s,
                       cudaStream_t stream) {
  switch (op) {
    case OP_ADD: return launch_add_sub<W>(false, a, b, out, count, s,
                                          stream);
    case OP_SUB: return launch_add_sub<W>(true, a, b, out, count, s, stream);
    case OP_MULT: return launch(MultMod<W>{}, a, b, nullptr, out, count, s,
                                stream);
    case OP_FMA: return launch_fma<W, false>(a, c, out, count, s, stream);
    case OP_REDUCE: return launch(ReduceMod<W>{}, a, nullptr, nullptr, out,
                                  count, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The approximate-quotient instantiations: the five 64-bit ops of
// jnp_kernels._approx().
static int launch_approx(int op, const u64* a, const u64* b, const u64* c,
                         u64* out, long long count, const Scalars& s,
                         cudaStream_t stream) {
  switch (op) {
    case OP_MULT: return launch(MultMod<u64, true>{}, a, b, nullptr, out,
                                count, s, stream);
    case OP_FMA: return launch_fma<u64, true>(a, c, out, count, s, stream);
    case OP_REDUCE: return launch(ReduceMod<u64, true>{}, a, nullptr,
                                  nullptr, out, count, s, stream);
    case OP_CMP_SUB: return launch(CmpSubMod<true>{}, a, nullptr, nullptr,
                                   out, count, s, stream);
    case OP_MONT_IN: return launch(MontIn<true>{}, a, nullptr, nullptr, out,
                                   count, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[i] = op(a[i], b[i], c[i]) for i < count; b and c may be null where
// the op takes a scalar or no operand. word is 64 or 32 (ops 0-4 only);
// approx (word 64, ops 2, 3, 4, 6 and 7) takes the approximate quotient.
// Every pointer 8-byte aligned.
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
    case OP_CMP_ADD: return launch(CmpAdd{}, a, nullptr, nullptr, out, count,
                                   s, stream);
    case OP_CMP_SUB: return launch(CmpSubMod<>{}, a, nullptr, nullptr, out,
                                   count, s, stream);
    case OP_MONT_IN: return launch(MontIn<>{}, a, nullptr, nullptr, out,
                                   count, s, stream);
    case OP_MONT_OUT: return launch(MontOut{}, a, nullptr, nullptr, out,
                                    count, s, stream);
    case OP_MONT_MULT: return launch(MontMult{}, a, b, nullptr, out, count,
                                     s, stream);
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
// The grid is (CTAs a row, k): a CTA reads its row's constants once and
// runs the flat kernel's span over its row (a row of an odd m may start
// 8 bytes off a 16-byte boundary: its head takes one element); together
// the rows' CTAs are at most one full wave where k allows.
template <typename F>
__global__ void __launch_bounds__(THREADS)
    eltwise_rows_kernel(F f, const u64* __restrict__ a,
                        const u64* __restrict__ b, u64* __restrict__ out,
                        const u64* __restrict__ consts, long long m, int op,
                        int factor) {
  const u64* c = consts + 4 * blockIdx.y;
  const Scalars s = op == OP_MULT
                        ? Scalars{c[0], c[1], 0, 0, (int)c[2], factor}
                        : Scalars{c[0], c[3], 0, 0, 1, factor};
  const long long off = (long long)blockIdx.y * m;
  span(f, a + off, F::B ? b + off : nullptr, nullptr, out + off, m, s,
       blockIdx.x, gridDim.x);
}

template <typename F>
static int launch_rows(F f, const u64* a, const u64* b, u64* out,
                       const u64* consts, int k, long long m, int op,
                       int factor, cudaStream_t stream) {
  static ResidentTable table;
  long long cap = 0;
  const int err = resident_ctas(table, eltwise_rows_kernel<F>, THREADS,
                                &cap);
  if (err) return err;
  const dim3 grid(grid_for((m + 1) / 2, cap / k), (unsigned)k);
  eltwise_rows_kernel<<<grid, THREADS, 0, stream>>>(f, a, b, out, consts, m, op, factor);
  return (int)cudaGetLastError();
}

// out[r][i] = op(a[r][i], b[r][i]) under row r's modulus, for r < k and
// i < m: op 2 (mult_mod, factor = the IMF) or 4 (reduce_mod from IMF = q
// to OMF factor), 64-bit; approx takes the approximate quotient.
extern "C" int hexl_eltwise_rows(const u64* a, const u64* b, u64* out,
                                 const u64* consts, int k, long long m,
                                 int op, int factor, int approx,
                                 cudaStream_t stream) {
  if (k < 1 || k > 65535 || m < 1 || (op != OP_MULT && op != OP_REDUCE) ||
      (op == OP_MULT && !b))
    return (int)cudaErrorInvalidValue;
  if (op == OP_MULT && approx)
    return launch_rows(MultMod<u64, true>{}, a, b, out, consts, k, m, op,
                       factor, stream);
  if (op == OP_MULT)
    return launch_rows(MultMod<u64>{}, a, b, out, consts, k, m, op, factor,
                       stream);
  if (approx)
    return launch_rows(ReduceMod<u64, true>{}, a, nullptr, out, consts, k, m,
                       op, factor, stream);
  return launch_rows(ReduceMod<u64>{}, a, nullptr, out, consts, k, m, op,
                     factor, stream);
}
