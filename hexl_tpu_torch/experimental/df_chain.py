"""K18: a chain of dependent FFT-like forward butterflies, and its plain
version, in double-float, f64 and single precision.

The port of the TPU kernel of `benchmarks/mosaic_df_bfly_ab.py` (its
pallas_call at :85): REPS dependent double-float complex forward butterflies
(`hexl_tpu/experimental/fft_like.py::_bfly_fwd_df`: X' = x + y w,
Y' = x - y w with w presplit, `df32.cdf_mul_ps`) with one unit twiddle, the
outputs swapped after each, then both scaled by 2^-REPS (`cdf_scale`). The
probe's shape is eight 8192 x 128 float32 planes (x and y, four each) and
its twiddle exp(0.7368791 i). The same chain runs in "f64" (complex128) and
"single" (complex64), the precisions of K12, whose arithmetic it shares
(`csrc/fft_arith.cuh`; the plain versions are `fft_like.arith`).

A value is as in `cuda_fft`: a complex tensor, or a `df32.CDF` of float32
planes. On the GPU `chain` launches K18 (`csrc/chain.cu`); on the CPU it
runs `chain_plain`. Launches are counted in `_build.launches` under
"K18.f64", "K18.f32" and "K18.df".
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import df32 as D
from . import fft_like
from . import cuda_fft
from .cuda_fft import planes, value

REPS = 8
ROWS, LANES = 8192, 128
ANGLE = 0.7368791
PRECISIONS = ("double_float", "f64", "single")
_CODE = {"f64": 0, "single": 1, "double_float": 2}
_SUFFIX = {"f64": "f64", "single": "f32", "double_float": "df"}

_P = ctypes.c_void_p
_ARGS = (ctypes.c_int,) + (_P,) * 20 + (ctypes.c_double, ctypes.c_double,
                                        ctypes.c_int, ctypes.c_longlong, _P)


def kernel_name(precision: str) -> str:
    return f"K18.{_SUFFIX[precision]}"


def twiddle(precision: str, device):
    """The probe's unit twiddle exp(ANGLE i) as a one-element value: in
    double-float hi = f32(re), lo = f32(re - hi) (and so for im), as the
    probe builds it."""
    wz = np.exp(1j * np.float64(ANGLE))
    if precision == "double_float":
        return D.cdf_from_complex128(np.array([wz]), device)
    dtype = torch.complex64 if precision == "single" else torch.complex128
    return torch.tensor([wz], dtype=dtype, device=device)


def shrink(precision: str, reps: int = REPS):
    """The closing scale 2^-reps: a float, or a DF (hi, lo) of float32
    scalars."""
    s = 2.0 ** -reps
    if precision == "double_float":
        return D.df_from_f64(np.float64(s))
    return s


def _scale_pair(s, precision: str) -> tuple:
    if precision == "double_float":
        return float(s.hi), float(s.lo)
    return float(s), 0.0


def _on_card(x, y, w, precision: str) -> bool:
    """The checks of `cuda_fft`'s wrappers (`cuda_fft.check_memory`); x
    and y of one shape, w of one element. True on a CUDA device (the
    kernel runs), False on the CPU (the plain version)."""
    if precision not in _CODE:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    dev = cuda_fft.check_memory((x, y, w), precision)
    shape = planes(x, precision)[0].shape
    if any(p.shape != shape for v in (x, y) for p in planes(v, precision)):
        raise ValueError("x and y must have one shape")
    if any(p.numel() != 1 for p in planes(w, precision)):
        raise ValueError("the twiddle must be one element")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def chain_plain(x, y, w, s, precision: str, reps: int = REPS) -> tuple:
    """`reps` butterflies (X' = x + y w, Y' = x - y w) swapping after each,
    then both scaled by s, in the plain arithmetic of `precision`."""
    ar = fft_like.arith(precision)
    xp, yp, wp = (planes(v, precision) for v in (x, y, w))
    for _ in range(reps):
        t = ar.mul(yp, wp)
        xp, yp = ar.sub(xp, t), ar.add(xp, t)
    return (value(ar.scale(xp, s), precision),
            value(ar.scale(yp, s), precision))


def chain(x, y, w, s, precision: str, reps: int = REPS) -> tuple:
    """The chain: K18 on the GPU, `chain_plain` on the CPU. x, y and w
    (one element) are values of the precision, contiguous, on one device;
    s a float, or a DF for double-float."""
    if not _on_card(x, y, w, precision):
        return chain_plain(x, y, w, s, precision, reps)
    ox, oy = (cuda_fft.empty_like(v, precision) for v in (x, y))
    count = planes(x, precision)[0].numel()
    if count == 0:
        return ox, oy
    fn = _build.function("chain", "hexl_df_chain", _ARGS)
    _build.launch_on(planes(x, precision)[0].device, kernel_name(precision),
                     fn, _CODE[precision],
                     *(ptr for v in (x, y, ox, oy, w)
                       for ptr in cuda_fft.pointers(v, precision)),
                     *_scale_pair(s, precision), reps, count)
    return ox, oy

