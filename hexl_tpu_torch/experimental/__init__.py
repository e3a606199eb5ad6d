"""Composite ops of the SEAL shim (the ciphertext product, the encrypted
linear-regression mat-vec, the CKKS key switch) and the FFT-like of CKKS
encode/decode. The module names `dyadic`, `key_switch` and `lr_mat_vec`
are shadowed by their functions here; reach them with importlib. The
module `fft_like` keeps its name."""

from .dyadic import dyadic_multiply
from .fft_like import FFTLike
from .key_switch import key_switch
from .lr_mat_vec import lr_mat_vec_mult

__all__ = ["dyadic_multiply", "key_switch", "lr_mat_vec_mult", "FFTLike"]
