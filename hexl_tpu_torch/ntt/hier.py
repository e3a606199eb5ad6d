"""The NTT above 2^14: the two-pass split and the wrappers of K5 and K6.

The counterpart of `hexl_tpu/ntt/hier.py`. A transform of degree
N = D * 2^14 (D = 2 .. 64) is viewed as D contiguous shards of
LOCAL_N = 2^14 coefficients. The stages of stride >= LOCAL_N pair equal
offsets of two shards (the cross pass); the others stay within a shard
(the local pass). The forward runs cross then local, with the OMF
reduction in the local pass; the inverse runs local then cross, with the
global final stage x N^-1 and the OMF reduction in the cross pass
(hier.py:293-316).

The plain versions are the flat walk of `torch_ntt` cut at stride LOCAL_N,
so the split is bit-identical to the flat walk, lazy outputs included.
On the GPU the cross pass is K5 (`csrc/ntt_hier.cu`, replacing
hier.py::_cross_call) and the local pass K6 (the kernels of
`csrc/ntt_block.cuh` with one shard per CTA, replacing ::_local_call). Both
read the plan's flat tables, a shard at its offset in them. `word` is 64,
or 32 for the single-word regime of q < 2^30 (`ntt32`), which runs the
u32 instantiation of both kernels. Launches are counted in
`_build.launches` under "K5"/"K6", or "K5.u32"/"K6.u32".
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, nt
from ..limb import reduce_mod_lazy64
from . import torch_ntt

LOCAL_N = 1 << 14

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_CROSS_FWD_ARGS = (_P, _P, _P, _P, _U, _I, _I, _I, _P)
_CROSS_INV_ARGS = (_P, _P, _P, _P, _U, _U, _U, _U, _U, _I, _I, _I, _I, _P)
_LOCAL_FWD_ARGS = (_P, _P, _P, _P, _U, _I, _I, _I, _I, _P)
_LOCAL_INV_ARGS = (_P, _P, _P, _P, _U, _I, _I, _I, _P)


def shards(plan) -> int:
    """D, the number of LOCAL_N shards of a transform of the plan's N."""
    if plan.n <= LOCAL_N:
        raise ValueError(f"the two-pass split needs N > 2^14, got {plan.n}")
    return plan.n // LOCAL_N


def kernel_name(kernel: str, word: int) -> str:
    return kernel if word == 64 else f"{kernel}.u32"


# -- plain versions: the flat walk cut at stride LOCAL_N --------------------

def cross_fwd_plain(x: torch.Tensor, plan, word: int = 64) -> torch.Tensor:
    """The forward stages of stride >= LOCAL_N (m < D blocks)."""
    return torch_ntt.fwd_stages(x, plan, 1, shards(plan), word)


def local_fwd_plain(x: torch.Tensor, plan, omf: int,
                    word: int = 64) -> torch.Tensor:
    """The forward stages of stride < LOCAL_N, then the OMF reduction."""
    x = torch_ntt.fwd_stages(x, plan, shards(plan), plan.n, word)
    if omf == 1:
        x = reduce_mod_lazy64(x, plan.q, 4)
    return x


def local_inv_plain(x: torch.Tensor, plan, word: int = 64) -> torch.Tensor:
    """The inverse stages of stride < LOCAL_N."""
    shards(plan)
    return torch_ntt.inv_stages(x, plan, 1, LOCAL_N, word)


def cross_inv_plain(x: torch.Tensor, plan, omf: int,
                    word: int = 64) -> torch.Tensor:
    """The inverse stages of stride >= LOCAL_N, the last fused with N^-1,
    then the OMF reduction."""
    shards(plan)
    x = torch_ntt.inv_stages(x, plan, LOCAL_N, plan.n // 2, word)
    return torch_ntt.inv_final(x, plan, omf, word)


# -- the kernel wrappers -----------------------------------------------------

def cross(x: torch.Tensor, plan, forward: bool, omf: int = 1,
          word: int = 64) -> torch.Tensor:
    """The cross pass of x (..., N): K5 on the GPU, the plain version on
    the CPU. The forward ignores omf."""
    log_d = nt.log2_exact(shards(plan))
    if not _build.on_card(x):
        if forward:
            return cross_fwd_plain(x, plan, word)
        return cross_inv_plain(x, plan, omf, word)
    out = torch.empty_like(x)
    batch = _build.batch_of(x, plan.n)
    if batch == 0:
        return out
    name = kernel_name("K5", word)
    if forward:
        rop, prop = plan.twiddles(x.device, True, word)
        fn = _build.function("ntt_hier", "hexl_cross_fwd", _CROSS_FWD_ARGS)
        _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                         rop.data_ptr(), prop.data_ptr(), plan.q, log_d, batch,
                         word)
    else:
        irop, pirop = plan.twiddles(x.device, False, word)
        start = torch_ntt.root_index(plan.n, LOCAL_N)
        fn = _build.function("ntt_hier", "hexl_cross_inv", _CROSS_INV_ARGS)
        _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                         irop[start:].data_ptr(), pirop[start:].data_ptr(),
                         plan.q, *plan.fin(word), log_d, batch, omf, word)
    return out


def local(x: torch.Tensor, plan, forward: bool, omf: int = 1,
          word: int = 64) -> torch.Tensor:
    """The local pass of x (..., N): K6 on the GPU, the plain version on
    the CPU. The inverse ignores omf."""
    log_d = nt.log2_exact(shards(plan))
    if not _build.on_card(x):
        if forward:
            return local_fwd_plain(x, plan, omf, word)
        return local_inv_plain(x, plan, word)
    out = torch.empty_like(x)
    _build.batch_of(x, LOCAL_N)      # the kernel counts shards in a C int
    batch = _build.batch_of(x, plan.n)
    if batch == 0:
        return out
    name = kernel_name("K6", word)
    w, wp = plan.twiddles(x.device, forward, word)
    if forward:
        fn = _build.function("ntt_hier", "hexl_local_fwd", _LOCAL_FWD_ARGS)
        _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                         w.data_ptr(), wp.data_ptr(), plan.q, log_d, batch,
                         omf, word)
    else:
        fn = _build.function("ntt_hier", "hexl_local_inv", _LOCAL_INV_ARGS)
        _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                         w.data_ptr(), wp.data_ptr(), plan.q, log_d, batch,
                         word)
    return out


def fwd_ntt(x: torch.Tensor, plan, omf: int = 1,
            word: int = 64) -> torch.Tensor:
    """Forward NTT of x (..., N), N > 2^14: cross pass, then local pass."""
    return local(cross(x, plan, True, omf, word), plan, True, omf, word)


def inv_ntt(x: torch.Tensor, plan, omf: int = 1,
            word: int = 64) -> torch.Tensor:
    """Inverse NTT of x (..., N), N > 2^14: local pass, then cross pass."""
    return cross(local(x, plan, False, omf, word), plan, False, omf, word)
