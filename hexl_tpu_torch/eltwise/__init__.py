"""Element-wise modular operations: the whole family of the JAX package."""

from .ops import (eltwise_add_mod, eltwise_cmp_add, eltwise_cmp_sub_mod,
                  eltwise_fma_mod, eltwise_montgomery_form_in,
                  eltwise_montgomery_form_out, eltwise_montgomery_mult_reduce,
                  eltwise_mult_mod, eltwise_reduce_mod, eltwise_sub_mod)

__all__ = [
    "eltwise_add_mod", "eltwise_sub_mod", "eltwise_mult_mod",
    "eltwise_fma_mod", "eltwise_reduce_mod", "eltwise_cmp_add",
    "eltwise_cmp_sub_mod", "eltwise_montgomery_form_in",
    "eltwise_montgomery_form_out", "eltwise_montgomery_mult_reduce",
]
