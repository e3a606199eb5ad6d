"""Wrappers of the NTT kernels K1 and K2 (`csrc/ntt.cu`).

The counterpart of `hexl_tpu/ntt/pallas_ntt.py` fwd_ntt/inv_ntt. K1
replaces pallas_ntt.py::_run (one polynomial per CTA, every stage in
shared memory); K2 replaces ::_packed_stage_kernel/_packed_call (several
polynomials of N <= 2^12 per CTA). The source note in `csrc/ntt.cu` says
what bounds them on an H100 and what the design does about it.

A tensor on the GPU goes to the kernel, a tensor on the CPU to the plain
version in `torch_ntt`; there is no other path. Launches are counted in
`_build.launches` under "K1" and "K2".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import torch_ntt

MAX_KERNEL_DEGREE = 1 << 14    # one CTA's shared memory holds 8N bytes
PACK_COEFFS = 1 << 13          # K2 fills a CTA with at most this many

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_FWD_ARGS = (_P, _P, _P, _P, _U, _I, _I, _I, _I, _P)
_INV_ARGS = (_P, _P, _P, _P, _U, _U, _U, _U, _U, _I, _I, _I, _I, _P)


def polys_per_cta(degree: int, batch: int, sms: int) -> int:
    """1 (K1), or P > 1 polynomials per CTA (K2) for N <= 2^12.

    P is the largest count that keeps a CTA within 2^13 coefficients and
    still gives every one of the card's `sms` SMs a CTA (ceil(batch/P) >=
    sms): packing fills a CTA only where the batch has CTAs to spare.
    `chip_smoke.py` times each P against this choice; PERF.md has the
    figures."""
    return max(1, min(PACK_COEFFS // degree, batch // sms))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(x: torch.Tensor, plan, imf: int, omf: int,
            forward: bool) -> torch.Tensor:
    torch_ntt.check_factors(forward, imf, omf)
    if x.dim() < 1 or x.shape[-1] != plan.n:
        raise ValueError(f"last dimension must be N={plan.n}, got "
                         f"{tuple(x.shape)}")
    if plan.n > MAX_KERNEL_DEGREE:
        raise NotImplementedError(
            f"N={plan.n} > 2^14: the two-pass split (hier.py) is not ported")
    if not _build.on_card(x):
        fn = torch_ntt.fwd_ntt if forward else torch_ntt.inv_ntt
        return fn(x, plan, imf, omf)
    out = torch.empty_like(x)
    batch = _build.batch_of(x, plan.n)
    if batch == 0:
        return out
    pp = polys_per_cta(plan.n, batch, sm_count(x.device))
    kernel = "K2" if pp > 1 else "K1"
    tabs = plan.tables(x.device)
    if forward:
        fn = _build.function("ntt", "hexl_ntt_fwd", _FWD_ARGS)
        _build.launch_on(x.device, kernel, fn, x.data_ptr(), out.data_ptr(),
                         tabs["rop"].data_ptr(), tabs["prop"].data_ptr(),
                         plan.q, plan.log_n, batch, pp, omf)
    else:
        fn = _build.function("ntt", "hexl_ntt_inv", _INV_ARGS)
        _build.launch_on(x.device, kernel, fn, x.data_ptr(), out.data_ptr(),
                         tabs["irop"].data_ptr(), tabs["pirop"].data_ptr(),
                         plan.q, plan.inv_n, plan.inv_n_precon, plan.inv_n_w,
                         plan.inv_n_w_precon, plan.log_n, batch, pp, omf)
    return out


def fwd_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1) -> torch.Tensor:
    """Forward NTT of x (..., N) through K1/K2 (CUDA) or the plain version
    (CPU); same contract as `torch_ntt.fwd_ntt`."""
    return _launch(x, plan, input_mod_factor, output_mod_factor, True)


def inv_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1) -> torch.Tensor:
    """Inverse NTT of x (..., N) through K1/K2 (CUDA) or the plain version
    (CPU); same contract as `torch_ntt.inv_ntt`."""
    return _launch(x, plan, input_mod_factor, output_mod_factor, False)
