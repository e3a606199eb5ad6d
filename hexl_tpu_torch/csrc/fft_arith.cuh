// The arithmetic of the FFT-like's kernels, as policies on one complex
// value: complex double (F64), complex float (F32) and complex double-float
// on four float32 planes (DfP, hexl_tpu_torch/experimental/df32.py op for
// op). Each policy loads and stores a value from its planes (Ptrs), adds,
// subtracts, multiplies by a twiddle (the presplit product cdf_mul_ps in
// double-float), takes the full product of the inverse's scaled final stage
// (cdf_mul) and scales by a real; `twiddle` and `mul_tw` take the product
// by a twiddle in two steps, so that the radix walk prepares each twiddle
// (its splits in double-float) once for every product that uses it.
// Shared by K12/K13 (fft.cu) and the double-float butterfly chain K18
// (chain.cu).
//
// No arithmetic here is contracted: every add, subtract and multiply is a
// round-to-nearest intrinsic (__dadd_rn, __fmul_rn, ...), which nvcc never
// fuses into an FMA. A contracted Dekker product is no longer error free,
// and with the intrinsics every policy is bit-exact against its plain
// PyTorch version, which is separate torch ops.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Up to four planes of one operand: the interleaved (re, im) array in f64
// and single, the (re.hi, re.lo, im.hi, im.lo) planes in double-float.
struct Ptrs {
  const void* p[4];
};

// ---- complex double and complex float --------------------------------------

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// Interleaved (re, im) of T: complex128 for double, complex64 for float.
template <class T>
struct Cx {
  static constexpr int THREADS = 1024;
  struct alignas(2 * sizeof(T)) V {
    T re, im;
  };
  struct S {
    T v;
  };
  static S scalar(double hi, double) { return {(T)hi}; }
  static __device__ __forceinline__ V load(const Ptrs& a, long long i) {
    return static_cast<const V*>(a.p[0])[i];
  }
  static __device__ __forceinline__ void store(const Ptrs& a, long long i,
                                               const V& v) {
    static_cast<V*>(const_cast<void*>(a.p[0]))[i] = v;
  }
  static __device__ __forceinline__ V add(const V& a, const V& b) {
    return {add_rn(a.re, b.re), add_rn(a.im, b.im)};
  }
  static __device__ __forceinline__ V sub(const V& a, const V& b) {
    return {sub_rn(a.re, b.re), sub_rn(a.im, b.im)};
  }
  // (ar br - ai bi, ar bi + ai br), the JAX formula.
  static __device__ __forceinline__ V mul(const V& a, const V& b) {
    return {sub_rn(mul_rn(a.re, b.re), mul_rn(a.im, b.im)),
            add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re))};
  }
  static __device__ __forceinline__ V mul_full(const V& a, const V& b) {
    return mul(a, b);
  }
  static __device__ __forceinline__ V scale(const V& a, const S& s) {
    return {mul_rn(a.re, s.v), mul_rn(a.im, s.v)};
  }
  // A twiddle as the radix walk holds it for the products of its block:
  // here the value itself.
  using Tw = V;
  static __device__ __forceinline__ Tw twiddle(const V& w) { return w; }
  static __device__ __forceinline__ V mul_tw(const V& a, const Tw& w) {
    return mul(a, w);
  }
};

using F64 = Cx<double>;
using F32 = Cx<float>;

// ---- double-float: df32.py, op for op ----------------------------------------

struct Df {
  float hi, lo;
};

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ Df norm(float s, float e) {
  const float hi = __fadd_rn(s, e);
  return {hi, __fsub_rn(e, __fsub_rn(hi, s))};
}

__device__ __forceinline__ Df df_add(const Df& x, const Df& y) {
  float s, e;
  two_sum(x.hi, y.hi, s, e);
  e = __fadd_rn(e, __fadd_rn(x.lo, y.lo));
  return norm(s, e);
}

__device__ __forceinline__ Df df_sub(const Df& x, const Df& y) {
  return df_add(x, Df{-y.hi, -y.lo});
}

__device__ __forceinline__ Df df_mul(const Df& x, const Df& y) {
  const float p = __fmul_rn(x.hi, y.hi);
  float ahi, alo, bhi, blo;
  split(x.hi, ahi, alo);
  split(y.hi, bhi, blo);
  float e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ahi, bhi), p),
                          __fmul_rn(ahi, blo)),
                __fmul_rn(alo, bhi)),
      __fmul_rn(alo, blo));
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(x.hi, y.lo), __fmul_rn(x.lo, y.hi)));
  return norm(p, e);
}

// df32._mul_ps: x*w with both splits in hand, as an unnormalized (p, e).
__device__ __forceinline__ void mul_ps(const Df& x, float x_shi, float x_slo,
                                       const Df& w, float w_shi, float w_slo,
                                       float& p, float& e) {
  p = __fmul_rn(x.hi, w.hi);
  e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(x_shi, w_shi), p),
                          __fmul_rn(x_shi, w_slo)),
                __fmul_rn(x_slo, w_shi)),
      __fmul_rn(x_slo, w_slo));
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(x.hi, w.lo), __fmul_rn(x.lo, w.hi)));
}

struct DfP {
  // Half the threads of the others: a double-float butterfly needs more
  // than the 64 registers a thread of a 1024-thread CTA may hold.
  static constexpr int THREADS = 512;
  struct __align__(16) V {
    Df re, im;
  };
  struct S {
    Df v;
  };
  static S scalar(double hi, double lo) { return {Df{(float)hi, (float)lo}}; }
  static __device__ __forceinline__ V load(const Ptrs& a, long long i) {
    return {Df{static_cast<const float*>(a.p[0])[i],
               static_cast<const float*>(a.p[1])[i]},
            Df{static_cast<const float*>(a.p[2])[i],
               static_cast<const float*>(a.p[3])[i]}};
  }
  static __device__ __forceinline__ void store(const Ptrs& a, long long i,
                                               const V& v) {
    static_cast<float*>(const_cast<void*>(a.p[0]))[i] = v.re.hi;
    static_cast<float*>(const_cast<void*>(a.p[1]))[i] = v.re.lo;
    static_cast<float*>(const_cast<void*>(a.p[2]))[i] = v.im.hi;
    static_cast<float*>(const_cast<void*>(a.p[3]))[i] = v.im.lo;
  }
  static __device__ __forceinline__ V add(const V& a, const V& b) {
    return {df_add(a.re, b.re), df_add(a.im, b.im)};
  }
  static __device__ __forceinline__ V sub(const V& a, const V& b) {
    return {df_sub(a.re, b.re), df_sub(a.im, b.im)};
  }
  // A twiddle with the 4097-splits of its high words (cdf_presplit): the
  // radix walk splits each twiddle it reads once, for every product of
  // its block.
  struct Tw {
    V w;
    float r_shi, r_slo, i_shi, i_slo;
  };
  static __device__ __forceinline__ Tw twiddle(const V& w) {
    Tw t;
    t.w = w;
    split(w.re.hi, t.r_shi, t.r_slo);
    split(w.im.hi, t.i_shi, t.i_slo);
    return t;
  }
  // cdf_mul_ps(x, cdf_presplit(w)).
  static __device__ __forceinline__ V mul_tw(const V& x, const Tw& t) {
    float xr_shi, xr_slo, xi_shi, xi_slo;
    split(x.re.hi, xr_shi, xr_slo);
    split(x.im.hi, xi_shi, xi_slo);
    float prr, err, pii, eii, pri, eri, pir, eir;
    mul_ps(x.re, xr_shi, xr_slo, t.w.re, t.r_shi, t.r_slo, prr, err);
    mul_ps(x.im, xi_shi, xi_slo, t.w.im, t.i_shi, t.i_slo, pii, eii);
    mul_ps(x.re, xr_shi, xr_slo, t.w.im, t.i_shi, t.i_slo, pri, eri);
    mul_ps(x.im, xi_shi, xi_slo, t.w.re, t.r_shi, t.r_slo, pir, eir);
    float sr, er, si, ei;
    two_sum(prr, -pii, sr, er);
    two_sum(pri, pir, si, ei);
    return {norm(sr, __fadd_rn(er, __fsub_rn(err, eii))),
            norm(si, __fadd_rn(ei, __fadd_rn(eri, eir)))};
  }
  static __device__ __forceinline__ V mul(const V& x, const V& w) {
    return mul_tw(x, twiddle(w));
  }
  // cdf_mul, the final inverse stage's product.
  static __device__ __forceinline__ V mul_full(const V& x, const V& y) {
    return {df_sub(df_mul(x.re, y.re), df_mul(x.im, y.im)),
            df_add(df_mul(x.re, y.im), df_mul(x.im, y.re))};
  }
  static __device__ __forceinline__ V scale(const V& a, const S& s) {
    return {df_mul(a.re, s.v), df_mul(a.im, s.v)};
  }
};
