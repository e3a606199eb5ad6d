"""hexl_tpu_torch: the PyTorch/CUDA port of hexl_tpu for NVIDIA Hopper.

The negacyclic NTT for every power-of-two N from 2 to 2^20 and every prime
q < 2^62 = 1 mod 2N (the 64-bit walk, and the single-word walk the JAX
engine takes for q < 2^30), the multi-modulus `RnsNTT`, element-wise
mult_mod, and the polynomial products `poly_mult_mod` and
`rns_poly_mult_mod`, computed by hand-written CUDA kernels (`csrc/`) on the
GPU and by their plain PyTorch versions on the CPU. Entry points run on
CUDA unless the caller passes device="cpu". The JAX package `hexl_tpu` is
the reference the port is tested against; this package imports nothing of
it.
"""

from . import nt
from .eltwise import eltwise_mult_mod
from .ntt import NTT, RnsNTT, get_plan, get_rns_plan, plan_from_arrays
from .poly import poly_mult_mod, rns_poly_mult_mod

__all__ = ["NTT", "RnsNTT", "get_plan", "get_rns_plan", "plan_from_arrays",
           "eltwise_mult_mod", "poly_mult_mod", "rns_poly_mult_mod", "nt"]
