"""The NTT for every N in both words, and the wrappers of K1, K2 and K7.

The counterpart of `hexl_tpu/ntt/pallas_ntt.py` fwd_ntt/inv_ntt and of
`hexl_tpu/ntt/ntt32.py`'s kernel. `word` is 64 (the 64-bit walk, for every
q < 2^62) or 32 (the single-word walk of q < 2^30, see `ntt32`). In one
CTA (`csrc/ntt.cu`), every kernel on the radix walk of `csrc/ntt_block.cuh`
(several stages a pass in registers, the transform in shared memory
between passes): at 64 bits and N <= 2^14, K1 replaces
pallas_ntt.py::_run (one polynomial per CTA) and K2 replaces
::_packed_stage_kernel/_packed_call (P > 1 polynomials of N < 2^8 per
CTA, `polys_per_cta`); at 32 bits and N <= 2^15, K7 replaces
ntt32.py::_run_pallas (one polynomial per CTA, 4N bytes). The source note
in `csrc/ntt.cu` says what bounds them on an H100 and what the design does
about it. Larger N runs the two-pass split of `hier` (K5, K6) in the same
word. The public `NTT` picks word 32 for q < 2^30 with N >= 1024, as the
JAX engine does; the poly-mult and RNS paths always run word 64, as the
JAX package's do. `scheme` (word 64 only) picks the butterflies, exact or
approximate (`torch_ntt`): each is a template instantiation of the
kernels, not a run-time branch in them.

K2's packing rule (`polys_per_cta`) is the card's: one polynomial per CTA
was fastest from N = 2^8 on at every batch timed, and below it a CTA of
one warp (the `pack` rows of `chip_smoke.py`, PERF.md's findings).

Where K1's grid (one polynomial a CTA, exact scheme) is under a wave and
`rns.cluster_for` picks clusters of C > 1 CTAs for it, the call runs the
cluster form of the stacked transform over a one-row basis of its prime
instead ("K1.rns.cl", `rns.cluster_transform`), bit for bit the same.

A tensor on the GPU goes to the kernel, a tensor on the CPU to the plain
version in `torch_ntt`; there is no other path. Launches are counted in
`_build.launches` under "K1", "K2" and "K7" (and "K1.rns.cl"), the
approximate instantiations under "K1.lean16", "K1.lean8", "K1.approx",
"K2.lean16", "K2.lean8" and "K2.approx".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import hier, torch_ntt

MAX_KERNEL_DEGREE = 1 << 14    # one CTA's shared memory holds 8N bytes
MAX_KERNEL_DEGREE32 = 1 << 15  # ... or 4N bytes in the single word
MAX_PACK_THREADS = 1024        # K2: P N/R threads a CTA, R = 8 (2 below 8)

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_FWD_ARGS = (_P, _P, _P, _P, _U, _I, _I, _I, _I, _I, _I, _P)
_INV_ARGS = (_P, _P, _P, _P, _U, _U, _U, _U, _U, _I, _I, _I, _I, _I, _I, _P)


def max_polys_per_cta(degree: int) -> int:
    """The most polynomials of `degree` K2 takes a CTA: one thread per group
    of R coefficients, at most MAX_PACK_THREADS threads."""
    return MAX_PACK_THREADS * (8 if degree >= 8 else 2) // degree


PACK_COEFFS = 1 << 8   # K2 packs a CTA of 256 coefficients


def polys_per_cta(degree: int, batch: int) -> int:
    """1 (K1), or P > 1 polynomials per CTA (K2) for N < 2^8.

    Packing pays only where one polynomial gives a CTA of less than a warp
    (N/8 < 32 groups of 8 coefficients): P makes a CTA of PACK_COEFFS
    coefficients (one warp from N = 8 on, four warps of 2-coefficient
    groups below), at most the largest power of two in the batch (K2
    takes P a power of two). The `pack` rows of `chip_smoke.py` time every
    P against this choice (PERF.md)."""
    return max(1, min(PACK_COEFFS // degree, 1 << (batch.bit_length() - 1)))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x: torch.Tensor, plan, imf: int, omf: int, forward: bool,
            word: int, scheme: str) -> torch.Tensor:
    torch_ntt.check_factors(forward, imf, omf)
    torch_ntt.check_scheme(scheme, plan.q, word)
    if word == 32 and plan.bit_shift != 32:
        raise ValueError(f"the single-word NTT needs q < 2^30, got {plan.q}")
    if x.dim() < 1 or x.shape[-1] != plan.n:
        raise ValueError(f"last dimension must be N={plan.n}, got "
                         f"{tuple(x.shape)}")
    if plan.n > (MAX_KERNEL_DEGREE32 if word == 32 else MAX_KERNEL_DEGREE):
        fn = hier.fwd_ntt if forward else hier.inv_ntt
        return fn(x, plan, omf, word, scheme)
    card = _build.on_card(x)
    batch = _build.batch_of(x, plan.n)
    if word == 32:
        pp, kernel = 1, "K7"
    else:
        pp = polys_per_cta(plan.n, batch)
        kernel = hier.kernel_name("K2" if pp > 1 else "K1", word, scheme)
    if kernel == "K1":
        from . import rns   # rns imports this module
        routed = rns.cluster_transform(x, plan, forward, omf, batch)
        if routed is not None:
            return routed
    if not card:
        fn = torch_ntt.fwd_ntt if forward else torch_ntt.inv_ntt
        return fn(x, plan, imf, omf, word, scheme)
    out = torch.empty_like(x)
    if batch == 0:
        return out
    w, wp = plan.twiddles(x.device, forward, word)
    if forward:
        fn = _build.function("ntt", "hexl_ntt_fwd", _FWD_ARGS)
        _build.launch_on(x.device, kernel, fn, x.data_ptr(), out.data_ptr(),
                         w.data_ptr(), wp.data_ptr(), plan.q, plan.log_n,
                         batch, pp, omf, word,
                         torch_ntt.SCHEME_CODE[scheme])
    else:
        fn = _build.function("ntt", "hexl_ntt_inv", _INV_ARGS)
        _build.launch_on(x.device, kernel, fn, x.data_ptr(), out.data_ptr(),
                         w.data_ptr(), wp.data_ptr(), plan.q, *plan.fin(word),
                         plan.log_n, batch, pp, omf, word,
                         torch_ntt.SCHEME_CODE[scheme])
    return out


def fwd_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1, word: int = 64,
            scheme: str = "exact") -> torch.Tensor:
    """Forward NTT of x (..., N) through K1/K2/K7 or K5/K6 (CUDA) or the
    plain versions (CPU); same contract as `torch_ntt.fwd_ntt`."""
    return _launch(x, plan, input_mod_factor, output_mod_factor, True, word,
                   scheme)


def inv_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1, word: int = 64,
            scheme: str = "exact") -> torch.Tensor:
    """Inverse NTT of x (..., N) through K1/K2/K7 or K5/K6 (CUDA) or the
    plain versions (CPU); same contract as `torch_ntt.inv_ntt`."""
    return _launch(x, plan, input_mod_factor, output_mod_factor, False, word,
                   scheme)
