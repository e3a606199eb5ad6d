"""hexl_tpu_torch: the PyTorch/CUDA port of hexl_tpu for NVIDIA Hopper.

The negacyclic NTT for every power-of-two N from 2 to 2^20 and every prime
q < 2^62 = 1 mod 2N (the 64-bit walk, and the single-word walk the JAX
engine takes for q < 2^30), the multi-modulus `RnsNTT`, the whole
element-wise family (add/sub, mult, fma, reduce, cmp_add, cmp_sub_mod and
the Montgomery ops, with the single-word regime of q < 2^30), the
polynomial products `poly_mult_mod` and `rns_poly_mult_mod`, the
composites `dyadic_multiply`, `lr_mat_vec_mult` and `key_switch`, the
four-step matmul NTT (`ntt.fwd_ntt_mxu`/`inv_ntt_mxu`) and the FFT-like of
CKKS encode/decode (`FFTLike`, with `build_floating_points`), computed
by hand-written CUDA kernels (`csrc/`) on the GPU and by their plain
PyTorch versions on the CPU. The parallel layer, `hexl_tpu_torch.parallel`
(the coefficient-sharded `DistNTT`, `dist_rns_poly_mult`, the
stage-pipelined `PipelineNTT` and the sharded composites over a mesh of
torch devices driven by this process), is imported on its own, not by this
package, as in the JAX package. Entry points run on CUDA unless the caller
passes device="cpu" (a mesh: devices=["cpu"] * k). The JAX package `hexl_tpu` is the reference the port
is tested against; this package imports nothing of it.
"""

from . import nt
from .eltwise import (eltwise_add_mod, eltwise_cmp_add, eltwise_cmp_sub_mod,
                      eltwise_fma_mod, eltwise_montgomery_form_in,
                      eltwise_montgomery_form_out,
                      eltwise_montgomery_mult_reduce, eltwise_mult_mod,
                      eltwise_reduce_mod, eltwise_sub_mod)
from .experimental import (FFTLike, dyadic_multiply, key_switch,
                           lr_mat_vec_mult)
from .ntt import NTT, RnsNTT, get_plan, get_rns_plan, plan_from_arrays
from .poly import poly_mult_mod, rns_poly_mult_mod

__all__ = ["NTT", "RnsNTT", "get_plan", "get_rns_plan", "plan_from_arrays",
           "eltwise_add_mod", "eltwise_sub_mod", "eltwise_mult_mod",
           "eltwise_fma_mod", "eltwise_reduce_mod", "eltwise_cmp_add",
           "eltwise_cmp_sub_mod", "eltwise_montgomery_form_in",
           "eltwise_montgomery_form_out", "eltwise_montgomery_mult_reduce",
           "dyadic_multiply", "lr_mat_vec_mult", "key_switch", "FFTLike",
           "poly_mult_mod", "rns_poly_mult_mod", "nt"]
