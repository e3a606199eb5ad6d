"""Plain single-word element-wise kernels for small moduli (q < 2^30).

The counterpart of `hexl_tpu/eltwise/jnp_kernels32.py`: every value < IMF*q
fits 32 bits, so each body reads the low 32 bits of its operands, computes
in 32-bit arithmetic and returns the result with a zero high word. For
in-range inputs that gives the 64-bit bodies' bits; for out-of-range
inputs the result is undefined in both packages. PyTorch has no uint32
arithmetic on the CPU, so the words are non-negative int64 values below
2^32, and a sum or product that would wrap in 32 bits is masked with
MASK32. The CUDA kernel K8 computes these in its u32 instantiation.
"""

from __future__ import annotations

import torch

from ..limb import MASK32, shr64


def _lo(v):
    return v & MASK32 if isinstance(v, torch.Tensor) else int(v) & MASK32


def _cond_sub32(x: torch.Tensor, c: int) -> torch.Tensor:
    return torch.where(x >= c, x - c, x)


def _reduce_lazy32(x: torch.Tensor, modulus: int,
                   input_mod_factor: int) -> torch.Tensor:
    if input_mod_factor >= 8:
        x = _cond_sub32(x, 4 * modulus)
    if input_mod_factor >= 4:
        x = _cond_sub32(x, 2 * modulus)
    if input_mod_factor >= 2:
        x = _cond_sub32(x, modulus)
    return x


def mult_constants32(modulus: int) -> tuple:
    """(mu, shift) of the single-word Barrett product: mu = floor(2^(n+30)
    / q) < 2^31 and shift = n - 2 for n = bits(q)."""
    n_bits = modulus.bit_length()
    return (1 << (n_bits + 30)) // modulus, n_bits - 2


def add_mod32(a: torch.Tensor, b, modulus: int) -> torch.Tensor:
    """(a + b) mod q on the low words; inputs in [0, q)."""
    return _cond_sub32((_lo(a) + _lo(b)) & MASK32, modulus)


def sub_mod32(a: torch.Tensor, b, modulus: int) -> torch.Tensor:
    """(a - b) mod q on the low words; inputs in [0, q)."""
    return _cond_sub32((_lo(a) + modulus - _lo(b)) & MASK32, modulus)


def _barrett_prod32(prod: torch.Tensor, modulus: int) -> torch.Tensor:
    """A product < 2^(2n) (as one int64 < 2^64) reduced to [0, 2q): the
    single-mulhi quotient on 32-bit words leaves z in [0, 4q)."""
    mu, shift = mult_constants32(modulus)
    hi, lo = shr64(prod, 32), prod & MASK32
    if shift == 0:
        c1 = lo
    elif shift < 32:
        c1 = (shr64(lo, shift) | (hi << (32 - shift))) & MASK32
    else:
        c1 = shr64(hi, shift - 32)
    q_hat = shr64(c1 * mu, 32)
    z = (lo - q_hat * modulus) & MASK32
    return _cond_sub32(z, 2 * modulus)


def mult_mod32(a: torch.Tensor, b: torch.Tensor, modulus: int,
               input_mod_factor: int = 1) -> torch.Tensor:
    """(a * b) mod q; inputs < IMF*q with IMF*q < 2^32; output [0, q)."""
    x = _reduce_lazy32(_lo(a), modulus, input_mod_factor)
    y = _reduce_lazy32(_lo(b), modulus, input_mod_factor)
    return _cond_sub32(_barrett_prod32(x * y, modulus), modulus)


def fma_mod32_preconned(a: torch.Tensor, w: int, wp: int, c, modulus: int,
                        input_mod_factor: int = 1) -> torch.Tensor:
    """(a * w + c) mod q by a 32-bit Shoup product: w = scalar mod q and
    wp = floor(w 2^32 / q); c may be None; a, c < IMF*q < 2^32."""
    x = _reduce_lazy32(_lo(a), modulus, input_mod_factor)
    q_hat = shr64(x * _lo(wp), 32)
    r = _cond_sub32((x * _lo(w) - q_hat * modulus) & MASK32, modulus)
    if c is None:
        return r
    a3 = _reduce_lazy32(_lo(c), modulus, input_mod_factor)
    return _cond_sub32((r + a3) & MASK32, modulus)


def reduce_mod32(a: torch.Tensor, modulus: int, input_mod_factor: int,
                 output_mod_factor: int) -> torch.Tensor:
    """Range change on the low word; IMF in {2, 4, modulus}."""
    if output_mod_factor not in (1, 2):
        raise ValueError("output_mod_factor must be 1 or 2")
    x = _lo(a)
    if input_mod_factor == output_mod_factor:
        return x
    if input_mod_factor == modulus:
        z = _barrett_prod32(x, modulus)
        return _cond_sub32(z, modulus) if output_mod_factor == 1 else z
    if input_mod_factor == 2:
        return _cond_sub32(x, modulus)
    if input_mod_factor == 4:
        z = _cond_sub32(x, 2 * modulus)
        return _cond_sub32(z, modulus) if output_mod_factor == 1 else z
    raise ValueError("input_mod_factor must be 2, 4, or == modulus")
