"""Plain PyTorch element-wise modular kernels on int64 tensors of u64 bits.

The counterpart of `hexl_tpu/eltwise/jnp_kernels.py`; this slice ports its
`mult_mod`. It runs on any device; the CUDA kernel K4 (`csrc/eltwise.cu`)
computes exactly this.
"""

from __future__ import annotations

import torch

from ..limb import mult_mod_barrett, reduce_mod_lazy64


def mult_mod(a: torch.Tensor, b: torch.Tensor, modulus: int,
             input_mod_factor: int = 1) -> torch.Tensor:
    """(a * b) mod q; inputs < IMF*q, IMF in {1,2,4}; output in [0, q)."""
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2 or 4")
    x = reduce_mod_lazy64(a, modulus, input_mod_factor)
    y = reduce_mod_lazy64(b, modulus, input_mod_factor)
    return mult_mod_barrett(x, y, modulus)
