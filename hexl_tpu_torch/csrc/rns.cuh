// A prime's row of a stacked launch over an RNS basis (K1.rns, K2.rns,
// K5.rns, K6.rns: ntt_rns.cu and cross_rns.cu).
//
// The stacked transform of hexl_tpu/ntt/rns.py puts the basis's k primes
// on a leading axis of the (k, ..., N) block and hands the per-prime
// scalars and tables to one program as operands with that axis. Here a
// launch takes a (k,) array of RnsRow in device memory
// (hexl_tpu_torch/ntt/rns.py RnsPlan.descriptors, built once per plan and
// device): a CTA reads its row's modulus and final-stage constants into
// registers, where the single-modulus kernels hold their arguments, and
// offsets its twiddle reads by the row's table addresses. The addresses are
// those of each prime's own plan tables (get_plan), so nothing is copied or
// stacked: at N = 2^17 x 16 primes stacked copies of the four tables would
// be 64 MiB beside the plans'.
#pragma once

#include "modarith.cuh"

struct RnsRow {
  u64 q;
  u64 inv_n, inv_n_precon, inv_n_w, inv_n_w_precon;
  const u64* rop;
  const u64* prop;
  const u64* irop;
  const u64* pirop;
};

// The row's words, mirrored by hexl_tpu_torch/ntt/rns.py ROW_WORDS.
constexpr int RNS_ROW_WORDS = 9;
static_assert(sizeof(RnsRow) == RNS_ROW_WORDS * sizeof(u64),
              "RnsRow is nine 64-bit words");

__device__ __forceinline__ InvFinal<u64> row_final(const RnsRow& r) {
  return {r.inv_n, r.inv_n_precon, r.inv_n_w, r.inv_n_w_precon};
}

// The most rows a launch takes: grid.y carries the row.
constexpr int RNS_MAX_ROWS = 65535;
