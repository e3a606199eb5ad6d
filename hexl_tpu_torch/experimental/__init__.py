"""Composite ops of the SEAL shim: the ciphertext product, the encrypted
linear-regression mat-vec and the CKKS key switch (`FFTLike` is still to
port)."""

from .dyadic import dyadic_multiply
from .key_switch import key_switch
from .lr_mat_vec import lr_mat_vec_mult

__all__ = ["dyadic_multiply", "key_switch", "lr_mat_vec_mult"]
