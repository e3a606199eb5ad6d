"""FFT-like transform for CKKS encode/decode (complex roots of X^N + 1).

The counterpart of `hexl_tpu/experimental/fft_like.py`: a radix-2 complex
transform over the 2N-th complex roots of unity with bit-reversed twiddle
tables and the reference's scale fusion. With a scalar, the forward output
is (1/scalar) x FFT and the inverse is (scalar/n) x the unnormalized
inverse, so the pair round-trips.

Precisions: "f64" (complex128), "single" (complex64) and "double_float"
(four float32 planes, `df32`); "auto" is "f64", the JAX rule for a backend
with native float64 (Hopper has it, and so has the CPU on which the JAX
tests run with x64). On a CUDA tensor every precision runs the kernels
K12/K13 of `cuda_fft`; the plain walks here run on the CPU, and on the
card only as what the kernels are held against. They are the JAX flat
walks `_stage_loop_fwd/_inv` and `_stage_loop_fwd_df/_inv_df`, cut by
stage so that the split above 2^13 (`cuda_fft`) runs the same stages in
the same order. Complex products are written on real and imaginary planes
as separate torch ops in the JAX formula (re = ar*br - ai*bi,
im = ar*bi + ai*br), never as torch's complex `*`, whose CUDA build may
contract into FMAs.

The JAX package's other walks of the double-float transform (the 2D
staged walk, radix fusion, lane packing, the split planes of "single" on
a TPU) are TPU scheduling, bit-identical to the flat walk by its own
tests, and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device, nt
from ..limb import MASK32, eq64, gt64, select64, shr64, u64_bits
from . import df32 as D

PRECISIONS = ("auto", "single", "double_float", "f64")
_CTYPE = {"f64": torch.complex128, "single": torch.complex64,
          "double_float": torch.complex128}


def build_tables(n: int):
    """Bit-reversed complex root tables (numpy complex128), computed as the
    JAX package computes them."""
    bits = nt.log2_exact(n)
    k = np.arange(2 * n)
    roots = np.exp(2j * np.pi * k / (2 * n))
    rev = np.array([nt.reverse_bits(i, bits) for i in range(n)])
    fwd = np.zeros(n, dtype=np.complex128)
    fwd[1:] = roots[rev[1:]]
    inv = np.zeros(n, dtype=np.complex128)
    inv[1:] = np.conj(roots[(rev[np.arange(1, n) - 1] + 1)])
    return fwd, inv


# -- arithmetic on tuples of planes -------------------------------------------
# A value is a tuple of real tensors: (re, im) for "f64" and "single",
# (re.hi, re.lo, im.hi, im.lo) for "double_float".

class ComplexArith:
    """Complex add, product and real scale on (re, im) planes."""

    @staticmethod
    def add(a, b):
        return (a[0] + b[0], a[1] + b[1])

    @staticmethod
    def sub(a, b):
        return (a[0] - b[0], a[1] - b[1])

    @staticmethod
    def mul(a, b):
        return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])

    mul_full = mul

    @staticmethod
    def scale(a, s):
        return (a[0] * s, a[1] * s)


class DoubleFloatArith:
    """The same on double-float planes: the butterflies' presplit product
    `cdf_mul_ps`, and the full `cdf_mul` of the inverse's scaled final
    stage."""

    @staticmethod
    def cdf(p) -> D.CDF:
        return D.CDF(D.DF(p[0], p[1]), D.DF(p[2], p[3]))

    @staticmethod
    def planes(c: D.CDF):
        return (c.re.hi, c.re.lo, c.im.hi, c.im.lo)

    @classmethod
    def add(cls, a, b):
        return cls.planes(D.cdf_add(cls.cdf(a), cls.cdf(b)))

    @classmethod
    def sub(cls, a, b):
        return cls.planes(D.cdf_sub(cls.cdf(a), cls.cdf(b)))

    @classmethod
    def mul(cls, a, w):
        return cls.planes(D.cdf_mul_ps(cls.cdf(a), D.cdf_presplit(cls.cdf(w))))

    @classmethod
    def mul_full(cls, a, w):
        return cls.planes(D.cdf_mul(cls.cdf(a), cls.cdf(w)))

    @classmethod
    def scale(cls, a, s: D.DF):
        return cls.planes(D.cdf_scale(cls.cdf(a), s))


def arith(precision: str):
    return DoubleFloatArith if precision == "double_float" else ComplexArith


# -- the flat walks, cut by stage -----------------------------------------------

def _halves(x, m: int, gap: int):
    """(xs, ys): the two halves of each of the m blocks of 2*gap."""
    lead = x[0].shape[:-1]
    v = [p.reshape(lead + (m, 2, gap)) for p in x]
    return tuple(p[..., 0, :] for p in v), tuple(p[..., 1, :] for p in v)


def _join(a, b, shape):
    return tuple(torch.stack([p, q], dim=-2).reshape(shape)
                 for p, q in zip(a, b))


def fwd_stages(x, table, n: int, m_first: int, m_stop: int, scalar, ar):
    """The forward stages with m_first <= m < m_stop blocks (stride
    n/(2m)) of x (planes (..., n)); the stage of stride 1 fuses `scalar`.
    Block k of the stage with m blocks reads table[m + k]."""
    shape = x[0].shape
    m = m_first
    while m < m_stop:
        gap = n // (2 * m)
        xs, ys = _halves(x, m, gap)
        w = tuple(p[m:2 * m, None] for p in table)
        if gap == 1 and scalar is not None:
            w = ar.scale(w, scalar)
            xs = ar.scale(xs, scalar)
        t = ar.mul(ys, w)
        x = _join(ar.add(xs, t), ar.sub(xs, t), shape)
        m <<= 1
    return x


def inv_stages(x, table, n: int, t_first: int, t_stop: int, ar):
    """The inverse stages of stride t_first <= t < t_stop. The stage of
    stride t has m = n/(2t) blocks; block k reads table[n + 1 - 2m + k]
    (the JAX walk's running root index)."""
    shape = x[0].shape
    gap = t_first
    while gap < t_stop:
        m = n // (2 * gap)
        first = n + 1 - 2 * m
        xs, ys = _halves(x, m, gap)
        w = tuple(p[first:first + m, None] for p in table)
        x = _join(ar.add(xs, ys), ar.mul(ar.sub(xs, ys), w), shape)
        gap <<= 1
    return x


def inv_final(x, table, n: int, scalar, ar):
    """The inverse's last stage (stride n/2): a plain stage without a
    scalar; with one, (xs + ys) * scalar and (xs - ys) * (table[n-1] *
    scalar) by the full product."""
    if scalar is None:
        return inv_stages(x, table, n, n // 2, n, ar)
    half = n // 2
    xs = tuple(p[..., :half] for p in x)
    ys = tuple(p[..., half:] for p in x)
    w = ar.scale(tuple(p[n - 1] for p in table), scalar)
    lo = ar.scale(ar.add(xs, ys), scalar)
    hi = ar.mul_full(ar.sub(xs, ys), w)
    return tuple(torch.cat([a, b], dim=-1) for a, b in zip(lo, hi))


def fwd_walk(x, table, n: int, scalar, ar):
    """The JAX flat forward walk (_stage_loop_fwd / _stage_loop_fwd_df)."""
    return fwd_stages(x, table, n, 1, n, scalar, ar)


def inv_walk(x, table, n: int, scalar, ar):
    """The JAX flat inverse walk (_stage_loop_inv / _stage_loop_inv_df)."""
    return inv_final(inv_stages(x, table, n, 1, n // 2, ar), table, n,
                     scalar, ar)


# -- the engine -------------------------------------------------------------------

class FFTLike:
    """Complex FFT-variant engine for degree-n vectors (n a power of 2
    above 8).

    precision: "auto" (= "f64"), "f64" (complex128), "single" (complex64)
    or "double_float" (float32 planes). device: where numpy inputs run
    (default CUDA, which must be present); tensor inputs run on their own
    device. numpy in gives numpy out."""

    def __init__(self, degree: int, scalar: float | None = None,
                 precision: str = "auto", device=None):
        if not nt.is_power_of_two(degree):
            raise ValueError("degree must be a power of two")
        if degree <= 8:
            raise ValueError("degree should be bigger than 8")
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of 'auto', 'single', "
                f"'double_float', 'f64'; got {precision!r}")
        self.device = _device.resolve(device)
        self.n = degree
        self.scalar = scalar
        self.scale = scalar / degree if scalar is not None else None
        self.inv_scale = 1.0 / scalar if scalar is not None else None
        self.precision = "f64" if precision == "auto" else precision
        self._host_tables = build_tables(degree)
        self._tables = {}
        self._scale_df = (D.df_from_f64(np.float64(self.scale))
                          if scalar is not None else None)
        self._inv_scale_df = (D.df_from_f64(np.float64(self.inv_scale))
                              if scalar is not None else None)
        self.fwd_table, self.inv_table = self.tables(self.device)

    def tables(self, device):
        """(forward, inverse) tables on `device` in the precision's form: a
        complex128 (f64) or complex64 (single) tensor, or a CDF of float32
        planes (double_float: hi = f32(x), lo = f32(x - hi))."""
        key = str(torch.device(device))
        tabs = self._tables.get(key)
        if tabs is None:
            if self.precision == "double_float":
                tabs = tuple(D.cdf_from_complex128(t, device)
                             for t in self._host_tables)
            else:
                tabs = tuple(torch.from_numpy(t).to(device,
                                                    _CTYPE[self.precision])
                             for t in self._host_tables)
            self._tables[key] = tabs
        return tabs

    def fused_scale(self, forward: bool):
        """The fused scale of a direction (1/scalar forward, scalar/n
        inverse) in the precision's form: a float (f64), a float's value
        rounded to float32 (single), a DF of 0-d CPU tensors
        (double_float); None without a scalar."""
        if self.scalar is None:
            return None
        if self.precision == "double_float":
            return self._inv_scale_df if forward else self._scale_df
        value = self.inv_scale if forward else self.scale
        return (float(np.float32(value)) if self.precision == "single"
                else value)

    def _run(self, x, forward: bool):
        host = not isinstance(x, torch.Tensor)
        ctype = _CTYPE[self.precision]
        if host:
            x = torch.from_numpy(np.asarray(x, dtype=np.complex128))
            x = x.to(self.device, ctype)
        else:
            # The kernels read memory: a lazy conjugate (z.conj()) or
            # negation is made real first.
            x = x.to(dtype=ctype).resolve_conj().resolve_neg().contiguous()
        if self.precision == "double_float":
            body = self.df_fwd_body if forward else self.df_inv_body
            out = D.cdf_to_complex128(body(D.cdf_from_complex128(x),
                                           self.fused_scale(forward)))
        else:
            fwd, inv = self.tables(x.device)
            fn = cuda_fft.forward if forward else cuda_fft.inverse
            out = fn(x, fwd if forward else inv,
                     self.fused_scale(forward), self.precision)
        return out.cpu().numpy() if host else out

    def forward(self, x):
        """Forward transform to bit-reversed order; x shape (..., n)."""
        return self._run(x, True)

    def inverse(self, x):
        """Inverse transform from bit-reversed order; x shape (..., n)."""
        return self._run(x, False)

    def _df_table(self, x: D.CDF, forward: bool):
        if self.precision != "double_float":
            raise ValueError("the double-float bodies need "
                             "precision='double_float'")
        return self.tables(x.re.hi.device)[0 if forward else 1]

    def df_fwd_body(self, x: D.CDF, scalar: D.DF | None = None) -> D.CDF:
        """Forward double-float body (CDF of float32 tensors -> CDF)."""
        return cuda_fft.forward(x, self._df_table(x, True), scalar,
                                "double_float")

    def df_inv_body(self, x: D.CDF, scalar: D.DF | None = None) -> D.CDF:
        """Inverse double-float body (CDF of float32 tensors -> CDF)."""
        return cuda_fft.inverse(x, self._df_table(x, False), scalar,
                                "double_float")

    def build_floating_points_device(self, plain, threshold,
                                     decryption_modulus, inv_scale) -> D.DF:
        """CRT-compose multi-word integers to scaled double-float planes on
        the device (the JAX package's output format: a DF of float32).

        plain: (mod_size, ...) words, little-endian (numpy uint64, or an
        int64 tensor of u64 bits, which stays on its device); values >=
        threshold are negative (value - decryption_modulus). The words'
        magnitudes are composed in float64, each word as two exact 32-bit
        halves, and split into hi/lo at the end: at least as accurate as
        the JAX package's double-float compose."""
        (words,), _ = _device.operands((plain,), self.device)
        mod_size = words.shape[0]
        thr = [int(threshold[w]) for w in range(mod_size)]
        dec = [int(decryption_modulus[w]) for w in range(mod_size)]
        # value >= threshold: multiword lexicographic compare, top down.
        ge = eq = None
        for w in range(mod_size - 1, -1, -1):
            gt_w, eq_w = gt64(words[w], thr[w]), eq64(words[w], thr[w])
            ge = gt_w if ge is None else ge | (eq & gt_w)
            eq = eq_w if eq is None else eq & eq_w
        neg = ge | eq
        # The magnitude of a negative value, dec - value, with borrow.
        mag = []
        borrow = None
        for w in range(mod_size):
            diff = u64_bits(dec[w]) - words[w]
            under = gt64(words[w], dec[w])
            if borrow is not None:
                under = under | (borrow & eq64(diff, 0))
                diff = torch.where(borrow, diff - 1, diff)
            mag.append(select64(neg, diff, words[w]))
            borrow = under
        acc = torch.zeros(words.shape[1:], dtype=torch.float64,
                          device=words.device)
        for w in range(mod_size):
            low = float(inv_scale) * 2.0 ** (64 * w)
            acc = acc + (mag[w] & MASK32).to(torch.float64) * low
            acc = acc + shr64(mag[w], 32).to(torch.float64) * (low * 2.0 ** 32)
        return D.df_from_f64(torch.where(neg, -acc, acc))

    def build_floating_points(self, plain, threshold, decryption_modulus,
                              inv_scale) -> np.ndarray:
        """CRT-compose multi-word integers to scaled complex doubles, on the
        host in Python integers and float64 (the JAX package's function).

        plain: (mod_size, n) uint64 words (little-endian) of the composed
        value; values >= threshold (also mod_size words) are negative
        (value - decryption_modulus)."""
        plain = np.asarray(plain, dtype=np.uint64)
        mod_size, n = plain.shape
        thr = 0
        dec = 0
        for w in range(mod_size):
            thr |= int(threshold[w]) << (64 * w)
            dec |= int(decryption_modulus[w]) << (64 * w)
        out = np.zeros(n, dtype=np.complex128)
        for i in range(n):
            v = 0
            for w in range(mod_size):
                v |= int(plain[w, i]) << (64 * w)
            if v >= thr:
                v -= dec
            out[i] = float(v) * inv_scale
        return out


from . import cuda_fft  # noqa: E402  (cuda_fft reads the walks above)
