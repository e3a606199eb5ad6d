"""Double-float (2 x float32) arithmetic: the plain version of K12/K13's DF.

The counterpart of `hexl_tpu/experimental/df32.py`: error-free
Dekker/Knuth arithmetic on pairs of float32 tensors, about 48 mantissa
bits. Every function is written as separate torch ops in the JAX order.
Separate ops are never contracted into FMAs, on the CPU or on the card, so
these bodies give the JAX package's eager bits and are what the kernels in
`csrc/fft.cu` are held against bit for bit (the kernels spell each op with
a round-to-nearest intrinsic for the same reason). `_two_prod` uses the
Dekker 12-bit split, which is exact in IEEE float32 multiply and add.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SPLITTER = 4097.0  # 2^12 + 1


class DF(NamedTuple):
    """hi + lo with |lo| <= ulp(hi)/2 (non-overlapping double-float)."""
    hi: torch.Tensor
    lo: torch.Tensor


class CDF(NamedTuple):
    """Complex double-float."""
    re: DF
    im: DF


class WS(NamedTuple):
    """DF with the Dekker split of `hi` precomputed (shi + slo == hi)."""
    hi: torch.Tensor
    lo: torch.Tensor
    shi: torch.Tensor
    slo: torch.Tensor


class CWS(NamedTuple):
    """Complex WS (presplit twiddle)."""
    re: WS
    im: WS


def df_from_f64(x, device=None) -> DF:
    """float64 values (numpy, a Python float or a float64 tensor) split into
    two non-overlapping float32 tensors: hi = f32(x), lo = f32(x - hi)."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=device or x.device, dtype=torch.float64)
    else:
        x = torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return DF(hi, lo)


def df_to_f64(x: DF) -> torch.Tensor:
    return x.hi.to(torch.float64) + x.lo.to(torch.float64)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def _norm(s, e) -> DF:
    hi = s + e
    return DF(hi, e - (hi - s))


def df_add(x: DF, y: DF) -> DF:
    s, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return _norm(s, e)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_mul(x: DF, y: DF) -> DF:
    p, e = _two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return _norm(p, e)


def cdf_add(x: CDF, y: CDF) -> CDF:
    return CDF(df_add(x.re, y.re), df_add(x.im, y.im))


def cdf_sub(x: CDF, y: CDF) -> CDF:
    return CDF(df_sub(x.re, y.re), df_sub(x.im, y.im))


def cdf_scale(x: CDF, s: DF) -> CDF:
    """Multiply a complex double-float by a real double-float."""
    return CDF(df_mul(x.re, s), df_mul(x.im, s))


def cdf_mul(x: CDF, y: CDF) -> CDF:
    re = df_sub(df_mul(x.re, y.re), df_mul(x.im, y.im))
    im = df_add(df_mul(x.re, y.im), df_mul(x.im, y.re))
    return CDF(re, im)


def df_presplit(x: DF) -> WS:
    shi, slo = _split(x.hi)
    return WS(x.hi, x.lo, shi, slo)


def cdf_presplit(x: CDF) -> CWS:
    return CWS(df_presplit(x.re), df_presplit(x.im))


def _mul_ps(x: DF, x_shi, x_slo, w: WS):
    """x*w with both splits in hand; an unnormalized (hi, err) pair."""
    p = x.hi * w.hi
    e = ((x_shi * w.shi - p) + x_shi * w.slo + x_slo * w.shi) \
        + x_slo * w.slo
    return p, e + (x.hi * w.lo + x.lo * w.hi)


def cdf_mul_ps(x: CDF, w: CWS) -> CDF:
    """x*w with w's splits precomputed and x's shared across the four real
    products; partial products stay unnormalized until the final combine
    (within about 1 ulp of cdf_mul, but not its bits)."""
    xr_shi, xr_slo = _split(x.re.hi)
    xi_shi, xi_slo = _split(x.im.hi)
    prr, err = _mul_ps(x.re, xr_shi, xr_slo, w.re)
    pii, eii = _mul_ps(x.im, xi_shi, xi_slo, w.im)
    pri, eri = _mul_ps(x.re, xr_shi, xr_slo, w.im)
    pir, eir = _mul_ps(x.im, xi_shi, xi_slo, w.re)
    sr, er = _two_sum(prr, -pii)
    si, ei = _two_sum(pri, pir)
    return CDF(_norm(sr, er + (err - eii)),
               _norm(si, ei + (eri + eir)))


def cdf_from_complex128(x, device=None) -> CDF:
    """Complex values (numpy or a complex tensor) as four float32 planes."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=device or x.device, dtype=torch.complex128)
    else:
        x = torch.as_tensor(np.asarray(x, dtype=np.complex128), device=device)
    return CDF(df_from_f64(x.real), df_from_f64(x.imag))


def cdf_to_complex128(x: CDF) -> torch.Tensor:
    return torch.complex(df_to_f64(x.re), df_to_f64(x.im))
