"""64-bit modular vocabulary on int64 tensors that carry u64 bit patterns.

The semantics of `hexl_tpu/limb.py` without its 2x32-bit layout. PyTorch has
no add, shift or compare for uint64 on the CPU, while int64 add, sub and mul
wrap mod 2^64 on every device, so a residue is an int64 tensor whose bits are
the u64 value (numpy uint64 `.view(np.int64)`). What differs from unsigned
arithmetic is written out here:

  * `>>` is arithmetic on int64, so a logical shift masks the sign copies;
  * the range halver tests the sign bit of the wrapped difference;
  * the high half of a 64x64 product is assembled from 32-bit halves;
  * `<` and the other compares are signed on int64, so the unsigned ones
    (`lt64` ...) flip the sign bit of both sides first, which maps u64
    order onto int64 order.

These functions are the plain PyTorch versions of the CUDA device functions
in `csrc/modarith.cuh`, and run on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from .nt import barrett_mult_constants

MASK32 = 0xFFFFFFFF
SIGN_BIT = -(1 << 63)          # the int64 whose bits are 2^63


def s64(value: int) -> int:
    """A u64 Python int as the int64 with the same bits."""
    value = int(value)
    if not 0 <= value < (1 << 64):
        raise ValueError("value out of uint64 range")
    return value - (1 << 64) if value >= (1 << 63) else value


def u64_bits(v):
    """A tensor as it is; a u64 Python int as its int64 bits."""
    return v if isinstance(v, torch.Tensor) else s64(v)


def _ordered(v):
    """u64 bits mapped onto int64 in the same order: the sign bit flipped."""
    return u64_bits(v) ^ SIGN_BIT


def eq64(x: torch.Tensor, y) -> torch.Tensor:
    return x == u64_bits(y)


def lt64(x: torch.Tensor, y) -> torch.Tensor:
    """Unsigned x < y; y a tensor or a u64 Python int."""
    return _ordered(x) < _ordered(y)


def le64(x: torch.Tensor, y) -> torch.Tensor:
    return _ordered(x) <= _ordered(y)


def ge64(x: torch.Tensor, y) -> torch.Tensor:
    return _ordered(x) >= _ordered(y)


def gt64(x: torch.Tensor, y) -> torch.Tensor:
    return _ordered(x) > _ordered(y)


def select64(mask: torch.Tensor, x, y) -> torch.Tensor:
    """mask ? x : y, element-wise."""
    return torch.where(mask, u64_bits(x), u64_bits(y))


def to_tensor(a, device) -> torch.Tensor:
    """numpy uint64 (or array-like) -> int64 tensor of the same bits and
    shape (a 0-d array stays 0-d)."""
    arr = np.asarray(a, dtype=np.uint64, order="C")
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 of the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)


def shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a static s in [0, 64)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def cond_sub64_half(x: torch.Tensor, c) -> torch.Tensor:
    """x >= c ? x - c : x, REQUIRING x < c + 2^63 and c <= 2^63.

    Under that contract (every range halver of this library: x < 2c with
    c a small multiple of q < 2^62) the wrapped difference is negative as
    an int64 exactly when x < c.
    """
    d = x - c
    return torch.where(d < 0, x, d)


def reduce_mod_lazy64(x: torch.Tensor, modulus: int,
                      input_mod_factor: int) -> torch.Tensor:
    """x mod q given x < input_mod_factor*q, by range halvers."""
    if input_mod_factor not in (1, 2, 4, 8):
        raise ValueError("input_mod_factor must be 1, 2, 4 or 8")
    if input_mod_factor >= 8:
        x = cond_sub64_half(x, s64(4 * modulus))
    if input_mod_factor >= 4:
        x = cond_sub64_half(x, s64(2 * modulus))
    if input_mod_factor >= 2:
        x = cond_sub64_half(x, s64(modulus))
    return x


def mul64_wide(x: torch.Tensor, y) -> tuple:
    """Full 64x64 -> 128 product as (hi, lo) from four 32x32 partials.

    Each partial is < 2^64, so its int64 bits are exact; every carry column
    stays below 2^34."""
    x0, x1 = x & MASK32, shr64(x, 32)
    y0, y1 = y & MASK32, shr64(y, 32)
    lo_lo = x0 * y0
    hi_lo = x1 * y0
    lo_hi = x0 * y1
    cross = shr64(lo_lo, 32) + (hi_lo & MASK32) + (lo_hi & MASK32)
    hi = x1 * y1 + shr64(hi_lo, 32) + shr64(lo_hi, 32) + shr64(cross, 32)
    return hi, x * y


def mulhi64(x: torch.Tensor, y) -> torch.Tensor:
    """High 64 bits of the 128-bit product."""
    return mul64_wide(x, y)[0]


def hi32_approx(a: torch.Tensor, b) -> torch.Tensor:
    """The high 32 bits of the product of two u32 values (held in int64),
    less 0, 1 or 2: `hexl_tpu/limb.py::hi32_approx`, from three 16-bit
    partial products with the carry of the middle column dropped. Every
    term is below 2^32, and so is their sum."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    return a1 * b1 + ((a0 * b1) >> 16) + ((a1 * b0) >> 16)


def mulhi64_approx6(x: torch.Tensor, y) -> torch.Tensor:
    """floor(x*y / 2^64) - e with e in [0, 6]: `hexl_tpu/limb.py::
    mulhi64_approx6` bit for bit. It drops the bit-32 column (x0 y0's high
    half and the low halves of the cross partials) and takes the cross
    partials' high halves from `hi32_approx`; the JAX form's two 32-bit
    carries are the 64-bit sum's own carries, so the result is
    x1 y1 + hi32_approx(x0, y1) + hi32_approx(x1, y0) mod 2^64."""
    x0, x1 = x & MASK32, shr64(x, 32)
    y0, y1 = u64_bits(y) & MASK32, shr64(u64_bits(y), 32)
    return x1 * y1 + hi32_approx(x0, y1) + hi32_approx(x1, y0)


def mulhi64_approx(x: torch.Tensor, y) -> torch.Tensor:
    """floor(x*y / 2^64) - e with e in {0, 1}: `hexl_tpu/limb.py::
    mulhi64_approx` bit for bit. The lo*lo partial product is dropped (its
    only effect on the high half is a carry of at most 1); x0 y1, x1 y0 and
    x1 y1 are kept whole, with the carry of the cross partials' low halves.
    The sum is at most the exact high word, so the int64 sum wraps to the
    JAX form's value. y: a tensor, or an int of u64 or int64 bits."""
    x0, x1 = x & MASK32, shr64(x, 32)
    y0, y1 = y & MASK32, shr64(y, 32)
    p01, p10 = x0 * y1, x1 * y0
    mid = (p01 & MASK32) + (p10 & MASK32)
    return x1 * y1 + shr64(p01, 32) + shr64(p10, 32) + shr64(mid, 32)


def mullo64(x: torch.Tensor, y) -> torch.Tensor:
    """(x * y) mod 2^64."""
    return x * y


def shr128_to64(hi: torch.Tensor, lo: torch.Tensor, s: int) -> torch.Tensor:
    """((hi:lo) >> s) truncated to 64 bits, static s in [0, 128)."""
    if s == 0:
        return lo
    if s < 64:
        return shr64(lo, s) | (hi << (64 - s))
    return shr64(hi, s - 64)


def shoup_mul_lazy(x: torch.Tensor, w, w_precon, modulus: int
                   ) -> torch.Tensor:
    """(x * w) mod q in [0, 2q): Harvey/Shoup multiplication.

    w_precon = floor(w << 64 / q) and w < q; the wrapped x*w - q_hat*q is
    exact because the true value lies in [0, 2q)."""
    q_hat = mulhi64(x, w_precon)
    return x * w - q_hat * s64(modulus)


def shoup_mul_lazy_approx(x: torch.Tensor, w, w_precon, modulus: int
                          ) -> torch.Tensor:
    """`shoup_mul_lazy` with the quotient from `mulhi64_approx`: the raw
    product lies in [0, 3q), and one halver at 2q brings it to [0, 2q)
    (`hexl_tpu/limb.py::shoup_mul_lazy_approx`). Equal to the exact form
    mod q, not bit for bit in the lazy range."""
    r = x * w - mulhi64_approx(x, w_precon) * s64(modulus)
    return cond_sub64_half(r, s64(2 * modulus))


def barrett_reduce_u64(x: torch.Tensor, modulus: int, q_barr: int,
                       output_mod_factor: int = 1) -> torch.Tensor:
    """x mod q via q_barr = floor(2^64/q); OMF=2 leaves the result in
    [0, 2q)."""
    q_hat = mulhi64(x, s64(q_barr))
    r = x - q_hat * s64(modulus)
    if output_mod_factor == 1:
        r = cond_sub64_half(r, s64(modulus))
    return r


def barrett_reduce_u64_approx(x: torch.Tensor, modulus: int, q_barr: int,
                              output_mod_factor: int = 1) -> torch.Tensor:
    """`barrett_reduce_u64` with the quotient from `mulhi64_approx`: the
    raw range [0, 3q) is halved at 2q to the OMF 2 contract, then at q for
    OMF 1 (`hexl_tpu/limb.py::barrett_reduce_u64_approx`)."""
    r = x - mulhi64_approx(x, s64(q_barr)) * s64(modulus)
    r = cond_sub64_half(r, s64(2 * modulus))
    if output_mod_factor == 1:
        r = cond_sub64_half(r, s64(modulus))
    return r


def mult_mod_barrett(x: torch.Tensor, y: torch.Tensor, modulus: int
                     ) -> torch.Tensor:
    """(x * y) mod q for x, y in [0, q), q < 2^62, output in [0, q).

    Generalized Barrett with a single mulhi quotient:
      n = bits(q); mu = floor(2^(n+62) / q)
      c1 = floor(x*y / 2^(n-2))     (fits in 64 bits)
      q_hat = floor(c1 * mu / 2^64)
      z = (x*y - q_hat*q) mod 2^64  in [0, 2q)
    """
    mu, shift = barrett_mult_constants(modulus)
    hi, lo = mul64_wide(x, y)
    c1 = shr128_to64(hi, lo, shift)
    q_hat = mulhi64(c1, s64(mu))
    z = lo - q_hat * s64(modulus)
    return cond_sub64_half(z, s64(modulus))


def mult_mod_barrett_approx(x: torch.Tensor, y: torch.Tensor, modulus: int
                            ) -> torch.Tensor:
    """`mult_mod_barrett` with the quotient from `mulhi64_approx`: the
    raw range [0, 3q) is halved at 2q, then at q
    (`hexl_tpu/limb.py::mult_mod_barrett_approx`); the output, in [0, q),
    equals the exact form's."""
    mu, shift = barrett_mult_constants(modulus)
    hi, lo = mul64_wide(x, y)
    c1 = shr128_to64(hi, lo, shift)
    z = lo - mulhi64_approx(c1, s64(mu)) * s64(modulus)
    z = cond_sub64_half(z, s64(2 * modulus))
    return cond_sub64_half(z, s64(modulus))


def mult_mod_barrett_rows(x: torch.Tensor, y: torch.Tensor,
                          q: torch.Tensor, mu: torch.Tensor,
                          shift: torch.Tensor,
                          approx: bool = False) -> torch.Tensor:
    """mult_mod_barrett (or, with approx, mult_mod_barrett_approx) with
    the modulus constants as tensors that broadcast against x and y (one
    (q, mu, shift) per row of an RNS stack), so that rows of any bit
    lengths share one call. Shifts run in two steps, (v << 1) << (63 - s),
    so that s = 0 needs no shift by 64."""
    hi, lo = mul64_wide(x, y)
    ones = torch.ones_like(shift)
    low_mask = ((ones << (63 - shift)) << 1) - 1
    c1 = ((lo >> shift) & low_mask) | ((hi << 1) << (63 - shift))
    if approx:
        z = cond_sub64_half(lo - mulhi64_approx(c1, mu) * q, 2 * q)
        return cond_sub64_half(z, q)
    q_hat = mulhi64(c1, mu)
    return cond_sub64_half(lo - q_hat * q, q)


def add128(x_hi: torch.Tensor, x_lo: torch.Tensor, y_hi: torch.Tensor,
           y_lo: torch.Tensor) -> tuple:
    """(x + y) mod 2^128 of two (hi, lo) pairs, as (hi, lo)."""
    lo = x_lo + y_lo
    return x_hi + y_hi + lt64(lo, x_lo).to(torch.int64), lo


def montgomery_reduce_u128(t_hi: torch.Tensor, t_lo: torch.Tensor,
                           modulus: int, inv_mod: int) -> torch.Tensor:
    """REDC: t * 2^-64 mod q for t = (t_hi, t_lo) in [0, 2^64 q), with
    q * inv_mod = -1 mod 2^64; output in [0, q). t + m q is divisible by
    2^64: the result is its high word, with the carry out of the low
    words found by an unsigned compare."""
    m = t_lo * s64(inv_mod)
    mq_hi, mq_lo = mul64_wide(m, s64(modulus))
    carry = lt64(t_lo + mq_lo, t_lo).to(torch.int64)
    return cond_sub64_half(t_hi + mq_hi + carry, s64(modulus))
