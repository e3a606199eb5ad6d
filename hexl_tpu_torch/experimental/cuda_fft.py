"""The FFT-like on the card: the wrappers of K12 and K13, and the split.

The counterpart of `hexl_tpu/experimental/pallas_fft.py` (`fwd_fft_df`,
`inv_fft_df`), for all three precisions. A value is a complex tensor
(complex128 for "f64", complex64 for "single") or a `df32.CDF` of float32
planes ("double_float"), shaped (..., n); a table is the same form of shape
(n,) on the value's device; a scalar is a float (f64, or a float32 value
for single), a DF (double_float), or None.

Up to BLOCK_N = 2^13 coefficients the whole transform is K12 (`csrc/fft.cu`,
in shared memory: one transform per CTA on the radix walk, or several per
CTA on the stage walk below PACK_BELOW, `transforms_per_cta`). Above, the
transform
of n = D * 2^13 is split as the NTT's is (`ntt/hier.py`): the stages of
stride >= 2^13 are the cross pass K13, the others the block pass K12 (the
radix walk, one block per CTA) on each of the D blocks; the forward runs cross then block, the inverse block
then cross (whose last stage carries the scalar). The kernels take n up to
MAX_KERNEL_N = 2^17 (D <= 16 coefficients per thread in K13).

A tensor on the GPU goes to the kernels, a tensor on the CPU to the plain
walks of `fft_like`, cut at the same stages; there is no other path.
Launches are counted in `_build.launches` under "K12.<p>" and "K13.<p>",
p being f64, f32 or df.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, nt
from ..ntt.cuda_ntt import sm_count
from . import df32 as D
from . import fft_like

BLOCK_N = 1 << 13
MAX_KERNEL_N = 1 << 17
# Below these degrees K12 packs several transforms per CTA (the stage walk)
# where the batch leaves CTAs to spare; from them on one transform per CTA
# (the radix walk) was faster at every batch timed (PERF.md's findings).
PACK_BELOW = {"f64": 1 << 7, "single": 1 << 7, "double_float": 1 << 9}
STAGE_WALK_COEFFS = 1 << 13   # the stage walk fills a CTA with at most these
_CODE = {"f64": 0, "single": 1, "double_float": 2}
_SUFFIX = {"f64": "f64", "single": "f32", "double_float": "df"}
_DTYPE = {"f64": torch.complex128, "single": torch.complex64,
          "double_float": torch.float32}

_P = ctypes.c_void_p
_D = ctypes.c_double
_I = ctypes.c_int
_BLOCK_ARGS = (_I,) + (_P,) * 12 + (_D, _D, _I, _I, _I, _I, _I, _I, _P)
_CROSS_ARGS = (_I,) + (_P,) * 12 + (_D, _D, _I, _I, _I, _I, _I, _P)


def kernel_name(kernel: str, precision: str) -> str:
    return f"{kernel}.{_SUFFIX[precision]}"


def planes(v, precision: str) -> tuple:
    """A value as its tuple of real planes."""
    if precision == "double_float":
        return (v.re.hi, v.re.lo, v.im.hi, v.im.lo)
    return (v.real, v.imag)


def value(p: tuple, precision: str):
    """The value of a tuple of real planes."""
    if precision == "double_float":
        return D.CDF(D.DF(p[0], p[1]), D.DF(p[2], p[3]))
    return torch.complex(p[0], p[1])


def degree(v, precision: str) -> int:
    n = planes(v, precision)[0].shape[-1]
    if n <= 8 or not nt.is_power_of_two(n):
        raise ValueError(f"the last dimension must be a power of two above "
                         f"8, got {n}")
    return n


# -- plain versions ---------------------------------------------------------------

def _plain(v, table, precision, fn, *args):
    out = fn(planes(v, precision), planes(table, precision),
             degree(v, precision), *args, fft_like.arith(precision))
    return value(out, precision)


def walk_plain(v, table, scalar, precision: str, forward: bool):
    """The whole flat walk: K12's function for n <= 2^13."""
    if forward:
        return _plain(v, table, precision, fft_like.fwd_walk, scalar)
    return _plain(v, table, precision, fft_like.inv_walk, scalar)


def _shards(n: int) -> int:
    if n <= BLOCK_N:
        raise ValueError(f"the split needs n > 2^13, got {n}")
    return n // BLOCK_N


def cross_plain(v, table, scalar, precision: str, forward: bool):
    """K13's function: the stages of stride >= 2^13 (forward: m < D
    blocks), the inverse's final stage with its scalar included."""
    n = degree(v, precision)
    d = _shards(n)
    if forward:
        return _plain(v, table, precision, fft_like.fwd_stages, 1, d, None)
    ar = fft_like.arith(precision)
    x = fft_like.inv_stages(planes(v, precision), planes(table, precision),
                            n, BLOCK_N, n // 2, ar)
    return value(fft_like.inv_final(x, planes(table, precision), n, scalar,
                                    ar), precision)


def block_plain(v, table, scalar, precision: str, forward: bool):
    """K12's function on the blocks of a split transform: the stages of
    stride < 2^13 (the forward's last one with its scalar)."""
    n = degree(v, precision)
    d = _shards(n)
    if forward:
        return _plain(v, table, precision, fft_like.fwd_stages, d, n, scalar)
    return _plain(v, table, precision, fft_like.inv_stages, 1, BLOCK_N)


# -- the kernel wrappers ------------------------------------------------------------

def check_memory(values, precision: str) -> torch.device:
    """The checks of a kernel's operands: every tensor of the values (a
    double-float value's planes) of the precision's type, contiguous, with
    no lazy conjugate or negation (a kernel reads the memory as it lies),
    on one device, which is returned."""
    tensors = ([p for v in values for p in planes(v, precision)]
               if precision == "double_float" else list(values))
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != _DTYPE[precision]:
            raise TypeError(f"{precision} expects {_DTYPE[precision]} "
                            f"tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.is_conj() or t.is_neg():
            raise ValueError("operands must not be lazy conjugates or "
                             "negations (resolve_conj/resolve_neg first)")
    return dev


def _on_card(v, table, precision: str) -> bool:
    """The wrappers' checks (`check_memory`, and the shapes). True on a
    CUDA device (the kernel runs), False on the CPU (the plain version
    runs)."""
    dev = check_memory((v, table), precision)
    shape = planes(v, precision)[0].shape
    if any(p.shape != shape for p in planes(v, precision)):
        raise ValueError("the planes of a value differ in shape")
    if planes(table, precision)[0].shape != (degree(v, precision),):
        raise ValueError("the table does not match the transform's degree")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and degree(v, precision) > MAX_KERNEL_N:
        raise ValueError(f"the kernels take n up to 2^17, got "
                         f"{degree(v, precision)}")
    return dev.type == "cuda"


def pointers(v, precision: str) -> list:
    if precision == "double_float":
        return [p.data_ptr() for p in planes(v, precision)]
    return [v.data_ptr(), None, None, None]


def empty_like(v, precision: str):
    if precision == "double_float":
        return value(tuple(torch.empty_like(p) for p in planes(v, precision)),
                     precision)
    return torch.empty_like(v)


def _scalar_args(scalar, precision: str) -> tuple:
    """(s_hi, s_lo, has_scalar) for a C entry."""
    if scalar is None:
        return 0.0, 0.0, 0
    if precision == "double_float":
        return float(scalar.hi), float(scalar.lo), 1
    return float(scalar), 0.0, 1


def stage_walk_packing(n: int, batch: int, sms: int) -> int:
    """The stage walk's transforms per CTA below PACK_BELOW: the largest
    count that keeps a CTA within STAGE_WALK_COEFFS coefficients and gives
    every one of the card's `sms` SMs a CTA (ceil(batch/P) >= sms). K12's
    figures below PACK_BELOW were measured with this rule (PERF.md)."""
    return max(1, min(STAGE_WALK_COEFFS // n, batch // sms))


def transforms_per_cta(n: int, batch: int, precision: str,
                       sms: int) -> int:
    """K12's transforms per CTA for a whole transform of degree n: 1 (the
    radix walk) from PACK_BELOW on, else `stage_walk_packing` (the stage
    walk where it gives P > 1)."""
    if n >= PACK_BELOW[precision]:
        return 1
    return stage_walk_packing(n, batch, sms)


def _device_of(v, precision: str) -> torch.device:
    return planes(v, precision)[0].device


def block(v, table, scalar, precision: str, forward: bool):
    """K12: the whole transform for n <= 2^13, else the block pass of the
    split (the plain versions on the CPU)."""
    n = degree(v, precision)
    if not _on_card(v, table, precision):
        fn = walk_plain if n <= BLOCK_N else block_plain
        return fn(v, table, scalar, precision, forward)
    out = empty_like(v, precision)
    batch = _build.batch_of(planes(v, precision)[0], n)
    if batch == 0:
        return out
    dev = _device_of(v, precision)
    if n <= BLOCK_N:
        log_n, log_d, chunks = nt.log2_exact(n), 0, batch
        pp = transforms_per_cta(n, batch, precision, sm_count(dev))
    else:
        log_n, log_d = nt.log2_exact(BLOCK_N), nt.log2_exact(n // BLOCK_N)
        chunks = _build.batch_of(planes(v, precision)[0], BLOCK_N)
        pp = 1
    fn = _build.function("fft", "hexl_fft_block", _BLOCK_ARGS)
    _build.launch_on(dev, kernel_name("K12", precision), fn,
                     _CODE[precision], *pointers(v, precision),
                     *pointers(out, precision), *pointers(table, precision),
                     *_scalar_args(scalar, precision), int(forward), log_n,
                     log_d, chunks, pp)
    return out


def cross(v, table, scalar, precision: str, forward: bool):
    """K13: the cross pass of n > 2^13 (the plain version on the CPU)."""
    n = degree(v, precision)
    log_d = nt.log2_exact(_shards(n))
    if not _on_card(v, table, precision):
        return cross_plain(v, table, scalar, precision, forward)
    out = empty_like(v, precision)
    batch = _build.batch_of(planes(v, precision)[0], n)
    if batch == 0:
        return out
    fn = _build.function("fft", "hexl_fft_cross", _CROSS_ARGS)
    _build.launch_on(_device_of(v, precision),
                     kernel_name("K13", precision), fn, _CODE[precision],
                     *pointers(v, precision), *pointers(out, precision),
                     *pointers(table, precision),
                     *_scalar_args(scalar, precision), int(forward),
                     nt.log2_exact(BLOCK_N), log_d, batch)
    return out


def forward(v, table, scalar, precision: str):
    """Forward FFT-like of v (..., n) to bit-reversed order, the last stage
    scaled by `scalar`: K12, or K13 then K12 above 2^13."""
    if degree(v, precision) <= BLOCK_N:
        return block(v, table, scalar, precision, True)
    return block(cross(v, table, None, precision, True), table, scalar,
                 precision, True)


def inverse(v, table, scalar, precision: str):
    """Inverse FFT-like of v (..., n) from bit-reversed order, the final
    stage scaled by `scalar`: K12, or K12 then K13 above 2^13."""
    if degree(v, precision) <= BLOCK_N:
        return block(v, table, scalar, precision, False)
    return cross(block(v, table, None, precision, False), table, scalar,
                 precision, False)
