"""hexl_tpu_torch: the PyTorch/CUDA port of hexl_tpu for NVIDIA Hopper.

The negacyclic 64-bit NTT, element-wise mult_mod and the fused polynomial
product, computed by hand-written CUDA kernels (`csrc/`) on the GPU and by
their plain PyTorch versions on the CPU. Entry points run on CUDA unless the
caller passes device="cpu". The JAX package `hexl_tpu` is the reference the
port is tested against; this package imports nothing of it.
"""

from . import nt
from .eltwise import eltwise_mult_mod
from .ntt import NTT, get_plan, plan_from_arrays
from .poly import poly_mult_mod

__all__ = ["NTT", "get_plan", "plan_from_arrays", "eltwise_mult_mod",
           "poly_mult_mod", "nt"]
