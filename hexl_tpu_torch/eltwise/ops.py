"""Public element-wise API and the wrapper of kernel K4 (`csrc/eltwise.cu`).

K4 replaces the `mult_mod` body of the TPU runner
`hexl_tpu/eltwise/pallas_kernels.py::run_eltwise`; the source note in
`csrc/eltwise.cu` says what bounds it on an H100 and what its design does
about it. A tensor on the GPU goes to the kernel, a tensor on the CPU to the
plain version in `torch_kernels`. Launches are counted in
`_build.launches` under "K4".
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, _device, nt
from ..limb import to_numpy
from . import torch_kernels

_P = ctypes.c_void_p
_MULT_MOD_ARGS = (_P, _P, _P, ctypes.c_int64, ctypes.c_uint64,
                  ctypes.c_uint64, ctypes.c_int, ctypes.c_int, _P)


def mult_mod(a: torch.Tensor, b: torch.Tensor, modulus: int,
             input_mod_factor: int = 1) -> torch.Tensor:
    """(a * b) mod q on int64 tensors of one shape and device: K4 on the
    GPU, the plain version on the CPU."""
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2 or 4")
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    mu, shift = nt.barrett_mult_constants(modulus)
    if not _build.on_card(a, b):
        return torch_kernels.mult_mod(a, b, modulus, input_mod_factor)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    fn = _build.function("eltwise", "hexl_mult_mod", _MULT_MOD_ARGS)
    _build.launch_on(a.device, "K4", fn, a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), a.numel(), modulus, mu, shift,
                     input_mod_factor)
    return out


def eltwise_mult_mod(a, b, modulus: int, input_mod_factor: int = 1,
                     device=None):
    """result[i] = (a[i] * b[i]) mod q; inputs < IMF*q, IMF in {1,2,4},
    q < 2^62; output in [0, q).

    int64 tensors of u64 bits run on their device; numpy uint64 operands
    run there too, else on `device` (default CUDA). The result is numpy iff
    an operand was numpy, as in the JAX package."""
    (ta, tb), host = _device.operands((a, b), device)
    out = mult_mod(ta, tb, modulus, input_mod_factor)
    return to_numpy(out) if host else out
