// The word-agnostic parts of the radix walk, shared by the NTT's
// (ntt_block.cuh: K1, K6, K7) and the FFT-like's (fft.cu: K12): the
// compile-time loop, the pass layout, the shared-memory swizzle, the
// twiddle bases and the shared-memory opt-in of the launches. A value V
// may be a u64 or u32 residue or a complex value of 8 or 16 bytes.
//
// The transform of n = 2^log_n is cut into n/R groups of R = 2^LOGR
// values; in the pass whose stages have strides 2^s .. 2^(s + LOGR - 1),
// group u holds the values base + i 2^s (i < R), base = u with LOGR zero
// bits inserted at bit s (radix_base). Between passes the transform rests
// in shared memory at the slots of radix_slot.
//
// Both transforms index their tables the same way. Forward block k of the
// stage with m blocks per shard reads table[m (2^log_d + shard) + k];
// inverse block k at stride 2^b reads table[1 + N - N/2^b + shard n/2^(b+1)
// + k] (N = n 2^log_d). In the pass with register bits at s, the stage of
// register bit j (stride 2^(s + j)) gives each group C = 2^(LOGR-1-j)
// butterfly blocks, consecutive from (u >> s) C, each of 2^j butterflies
// (i, i + 2^j); its twiddles start at g >> j, with g formed once a pass
// (radix_fwd_g; radix_inv_g, relative to entry 1 + N): every term of the
// flat index is a multiple of 2^j there, so one shift gives it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// A loop index known at compile time.
template <int I>
struct Index {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(i) for i = I .. N-1, each i an Index: every index into a thread's
// value array is a constant of the program, so the array stays in
// registers whatever the unroller does (a #pragma unroll loop left K5's
// inverse array on the stack from D = 32 on).
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Index<I>{});
    static_for<I + 1, N>(f);
  }
}

// The shared-memory slot of value i: bits 0-4 XORed with bits LOGR ..
// LOGR + 4, a bijection on [0, n) that makes every pass's stores and loads
// (a warp's lanes at radix_base, each register at its own stride) free of
// bank conflicts for values of 4, 8 and 16 bytes (tests/test_torch_radix.py
// counts the conflicts of every pass).
template <int LOGR>
__host__ __device__ __forceinline__ int radix_slot(int i) {
  return i ^ ((i >> LOGR) & 31);
}

// The first of group t's values in the pass of strides 2^s ..
// 2^(s + LOGR - 1): t with LOGR zero bits inserted at bit s.
template <int LOGR>
__host__ __device__ __forceinline__ int radix_base(int t, int s) {
  return (t & ((1 << s) - 1)) | ((t >> s) << (s + LOGR));
}

template <typename V, int LOGR>
__device__ __forceinline__ void radix_put(V* sm, const V (&v)[1 << LOGR],
                                          int t, int s) {
  const int base = radix_base<LOGR>(t, s);
  static_for<0, (1 << LOGR)>([&](auto i) {
    sm[radix_slot<LOGR>(base + (decltype(i)::value << s))] = v[i];
  });
}

template <typename V, int LOGR>
__device__ __forceinline__ void radix_get(const V* sm, V (&v)[1 << LOGR],
                                          int t, int s) {
  const int base = radix_base<LOGR>(t, s);
  static_for<0, (1 << LOGR)>([&](auto i) {
    v[i] = sm[radix_slot<LOGR>(base + (decltype(i)::value << s))];
  });
}

// The forward's twiddle base of group t in the pass at s: block k of the
// stage of register bit j reads table[(g >> j) + k].
__device__ __forceinline__ int radix_fwd_g(int first_block, int log_n, int s,
                                           int t, int logr) {
  return (first_block << (log_n - 1 - s)) + ((t >> s) << (logr - 1));
}

// The inverse's, relative to table entry 1 + N (negative).
__device__ __forceinline__ int radix_inv_g(int shard, int log_n,
                                           int log_big_n, int s, int t,
                                           int logr) {
  return (shard << (log_n - 1 - s)) - (1 << (log_big_n - s)) +
         ((t >> s) << (logr - 1));
}
