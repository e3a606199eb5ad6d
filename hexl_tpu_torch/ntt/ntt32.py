"""The single-word NTT for q < 2^30: the plain walk.

The counterpart of `hexl_tpu/ntt/ntt32.py`. When 4q < 2^32, every lazy
value of the Harvey walk fits one u32 word, and the Shoup multiply becomes
a 32-bit mulhi against twiddles preconditioned at 2^32 (`plan.prop32`,
`plan.pirop32`). The lazy outputs therefore differ in value from the 64-bit
walk's (by multiples of q); the fully reduced ones agree. The JAX engine
takes this regime for q < 2^30 and N >= 1024 (`NttPlan.single_word`), and
so does the port's `NTT`.

`fwd_ntt32`/`inv_ntt32` are the plain single-word walk (the counterpart of
ntt32.fwd_ntt32/inv_ntt32): `torch_ntt`'s stages with word=32, on int64
tensors holding u32 values; the forward ends with the reduction by 2q then
q (`_reduce4`), and the inverse fuses its final stage with the precon32
constants of N^-1. The regime runs through `cuda_ntt.fwd_ntt`/`inv_ntt`
with word=32: the kernel K7 for N <= 2^15 (`csrc/ntt.cu`, replacing
ntt32.py::_run_pallas), the u32 instantiation of the two-pass split
(`hier`, K5/K6) above, and this plain walk for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from . import torch_ntt


def fwd_ntt32(x: torch.Tensor, plan, input_mod_factor: int = 1,
              output_mod_factor: int = 1) -> torch.Tensor:
    """The plain single-word forward NTT of x (..., N), q < 2^30."""
    return torch_ntt.fwd_ntt(x, plan, input_mod_factor, output_mod_factor,
                             word=32)


def inv_ntt32(x: torch.Tensor, plan, input_mod_factor: int = 1,
              output_mod_factor: int = 1) -> torch.Tensor:
    """The plain single-word inverse NTT of x (..., N), q < 2^30."""
    return torch_ntt.inv_ntt(x, plan, input_mod_factor, output_mod_factor,
                             word=32)
