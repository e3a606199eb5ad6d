"""Element-wise modular operations (this slice: mult_mod)."""

from .ops import eltwise_mult_mod

__all__ = ["eltwise_mult_mod"]
