// K1, K2 and K7: the whole negacyclic NTT of a polynomial in one CTA.
//
// Replaces the TPU kernels hexl_tpu/ntt/pallas_ntt.py::_run (K1, every
// stage of one polynomial resident in VMEM), ::_packed_stage_kernel /
// _packed_call (K2, several small polynomials per grid step) and
// hexl_tpu/ntt/ntt32.py::_run_pallas (K7, the single-word transform of
// q < 2^30: one uint32 plane per polynomial, Shoup on a 32-bit mulhi,
// twiddles preconditioned at 2^32). `word` and the polynomials per CTA
// pick the kernel; every one runs the radix walk of ntt_block.cuh
// (registers hold the coefficients through several stages a pass, shared
// memory holds the transform between passes, each coefficient is read and
// written once). Word 64 with one polynomial per CTA is K1 (N <= 2^14, 8N
// bytes). Word 32 is K7, always one polynomial per CTA (N <= 2^15): the
// int64 input narrowed to u32 on the load (4N bytes of shared memory,
// 128 KB at N = 2^15), Shoup on __umulhi and the precon32 tables, the
// whole-transform inverse's last stage fused with N^-1 and the OMF
// reduction, the store widened back; every lazy value is < 4q < 2^32, so
// it is bit-identical to hexl_tpu_torch/ntt/ntt32.py::fwd_ntt32/inv_ntt32
// and to the JAX single-word path, lazy outputs included. Word 64 with
// P > 1 polynomials per CTA is K2 (the packed radix walk: the P
// transforms' groups one virtual transform of the slots, a ragged last
// CTA masked, a warp's barrier ending a pass where a transform's groups
// lie in one warp); ntt/cuda_ntt.py::polys_per_cta packs only where the
// card showed it faster than one polynomial per CTA, the small N at which
// one polynomial gives a CTA of less than a warp. The 64-bit kernels also
// run in the lean16 and lean8 schemes of the JAX engine's device bodies
// (hexl_tpu/ntt/jnp_ntt.py::_bflys3, the approximate Shoup quotient
// mulhi64_approx6): one more instantiation of each kernel per scheme,
// bit-identical to the plain lean walk. On Hopper the approximate
// quotient saves no multiply: a 32x32 high product is one IMAD, so its
// 16-bit partial products cost as much as the exact 64x64 high product,
// and the exact Harvey forward already has one halver, as lean16 does.
//
// What bounds them on an H100: reading and writing each coefficient once
// (plus the twiddle tables) moves 16 bytes per coefficient (the tensors
// stay int64 in both words), while each of the N/2 log N butterflies
// issues one 64x64 high product and two low products (K1, K2), or one
// 32-bit high product and two low ones (K7); with the 64-bit adds,
// compares and selects around them a 64-bit butterfly is about 50
// instructions, so K1 is bound by instruction issue, K7 by bytes, and one
// CTA a SM at 2^14 leaves K1's first load and last store exposed
// (ntt_block.cuh says what the radix walk does about each). K2's small
// transforms do few butterflies a coefficient: they are bound by bytes,
// and a CTA of a few threads by the launch of its CTAs, which packing
// amortises.
#include "ntt_block.cuh"

// word is 64, or 32 for q < 2^30, where the precon tables and constants
// are the plan's precon32 ones and polys_per_cta must be 1; scheme is a
// Scheme code (modarith.cuh), a lean one with word 64 only.
extern "C" int hexl_ntt_fwd(const u64* x, u64* y, const u64* rop,
                            const u64* prop, u64 q, int log_n, int batch,
                            int polys_per_cta, int omf, int word, int scheme,
                            cudaStream_t stream) {
  if (word == 32) {
    if (polys_per_cta != 1) return (int)cudaErrorInvalidValue;
    return launch_radix_fwd_scheme<u32>(scheme, x, y, rop, prop, q, log_n,
                                        batch, omf, 0, 0, 0, stream);
  }
  if (polys_per_cta == 1)
    return launch_radix_fwd_scheme<u64>(scheme, x, y, rop, prop, q, log_n,
                                        batch, omf, 0, 0, 0, stream);
  return launch_packed_fwd(scheme, x, y, rop, prop, q, log_n, batch,
                           polys_per_cta, omf, stream);
}

extern "C" int hexl_ntt_inv(const u64* x, u64* y, const u64* irop,
                            const u64* pirop, u64 q, u64 inv_n,
                            u64 inv_n_precon, u64 inv_n_w, u64 inv_n_w_precon,
                            int log_n, int batch, int polys_per_cta, int omf,
                            int word, int scheme, cudaStream_t stream) {
  if (word == 32) {
    if (polys_per_cta != 1) return (int)cudaErrorInvalidValue;
    const InvFinal<u32> fin = {(u32)inv_n, (u32)inv_n_precon, (u32)inv_n_w,
                               (u32)inv_n_w_precon};
    return launch_radix_inv_scheme<u32, true>(scheme, x, y, irop, pirop, q,
                                              fin, log_n, batch, omf, 0, 0,
                                              0, stream);
  }
  const InvFinal<u64> fin = {inv_n, inv_n_precon, inv_n_w, inv_n_w_precon};
  if (polys_per_cta == 1)
    return launch_radix_inv_scheme<u64, true>(scheme, x, y, irop, pirop, q,
                                              fin, log_n, batch, omf, 0, 0,
                                              0, stream);
  return launch_packed_inv(scheme, x, y, irop, pirop, q, fin, log_n, batch,
                           polys_per_cta, omf, stream);
}
