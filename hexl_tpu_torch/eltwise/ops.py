"""Public element-wise API and the wrappers of kernels K4 and K8.

The counterpart of `hexl_tpu/eltwise/ops.py`: the ten public functions with
its signatures, its debug validation (`utils.check`, on with
HEXL_TPU_DEBUG=1) and its choice of regime (`_jitted_impl`, ops.py:58-127):
the single word (q < 2^30) for add/sub, for mult_mod and fma_mod when
also IMF*q < 2^32, and for reduce_mod at IMF 2 or 4; everything else, and
the cmp and Montgomery families always, in 64 bits. fma_mod reduces its
scalar and preconditions it on the host at 2^32 or 2^64 by that regime.

The tensor-level wrappers below (`add_mod`, ...) take int64 tensors of u64
bits and a `word` (64 or 32). A tensor on the GPU goes to the kernel of
`csrc/eltwise.cu`, which replaces the bodies of the TPU runner
`hexl_tpu/eltwise/pallas_kernels.py::run_eltwise` (its source note says
what bounds it on an H100); a tensor on the CPU goes to the plain version
in `torch_kernels` (64-bit) or `torch_kernels32` (single word). Launches
are counted in `_build.launches` under "K4" (mult_mod, 64-bit) and
"K8.<family>" (add_sub, mult, fma, reduce, cmp, mont), with ".u32" for the
single word.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, _device, nt
from ..limb import to_numpy
from ..utils import check as _chk
from . import torch_kernels as K
from . import torch_kernels32 as K32

SMALL_Q = 1 << 30     # the single-word regime's bound on q

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, ctypes.c_int64, _I, _I, _U, _U, _U, _U, _I, _I, _P)
_OP = {"add": 0, "sub": 1, "mult": 2, "fma": 3, "reduce": 4, "cmp_add": 5,
       "cmp_sub": 6, "mont_in": 7, "mont_out": 8, "mont_mult": 9}
_FAMILY = {"add": "add_sub", "sub": "add_sub", "mult": "mult", "fma": "fma",
           "reduce": "reduce", "cmp_add": "cmp", "cmp_sub": "cmp",
           "mont_in": "mont", "mont_out": "mont", "mont_mult": "mont"}


def kernel_name(op: str, word: int = 64) -> str:
    """The launch count's name of an op in a word."""
    if op == "mult" and word == 64:
        return "K4"
    return f"K8.{_FAMILY[op]}" + (".u32" if word == 32 else "")


def _u64(value) -> int:
    value = int(value)
    if not 0 <= value < (1 << 64):
        raise ValueError(f"scalar {value} out of uint64 range")
    return value


def _on_card(a: torch.Tensor, *others) -> bool:
    """The operand checks: the vector operands have a's shape; the
    kernel runs iff they lie on a CUDA device."""
    vectors = [a] + [t for t in others if isinstance(t, torch.Tensor)]
    for t in vectors[1:]:
        if t.shape != a.shape:
            raise ValueError(f"shapes differ: {tuple(a.shape)} vs "
                             f"{tuple(t.shape)}")
    return _build.on_card(*vectors)


def _launch(op: str, word: int, a: torch.Tensor, b=None, c=None,
            q: int = 0, s=(0, 0, 0), i=(0, 0)) -> torch.Tensor:
    if word not in (32, 64):
        raise ValueError("word must be 64 or 32")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    fn = _build.function("eltwise", "hexl_eltwise", _ARGS)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch_on(a.device, kernel_name(op, word), fn, a.data_ptr(),
                     ptr(b), ptr(c), out.data_ptr(), a.numel(), _OP[op],
                     word, q, *(_u64(v) for v in s), *i)
    return out


# -- the tensor-level wrappers (kernel on the GPU, plain on the CPU) ---------

def add_mod(a: torch.Tensor, b, modulus: int, word: int = 64):
    """(a + b) mod q; b a tensor of a's shape or a scalar; inputs < q."""
    if not _on_card(a, b):
        return (K32.add_mod32 if word == 32 else K.add_mod)(a, b, modulus)
    vec = isinstance(b, torch.Tensor)
    return _launch("add", word, a, b if vec else None, q=modulus,
                   s=(0 if vec else b, 0, 0))


def sub_mod(a: torch.Tensor, b, modulus: int, word: int = 64):
    """(a - b) mod q; b a tensor of a's shape or a scalar; inputs < q."""
    if not _on_card(a, b):
        return (K32.sub_mod32 if word == 32 else K.sub_mod)(a, b, modulus)
    vec = isinstance(b, torch.Tensor)
    return _launch("sub", word, a, b if vec else None, q=modulus,
                   s=(0 if vec else b, 0, 0))


def mult_mod(a: torch.Tensor, b: torch.Tensor, modulus: int,
             input_mod_factor: int = 1, word: int = 64) -> torch.Tensor:
    """(a * b) mod q, inputs < IMF*q, IMF in {1, 2, 4}."""
    if input_mod_factor not in (1, 2, 4):
        raise ValueError("input_mod_factor must be 1, 2 or 4")
    if word == 32:
        mu, shift = K32.mult_constants32(modulus)
    else:
        mu, shift = nt.barrett_mult_constants(modulus)
    if not _on_card(a, b):
        if word == 32:
            return K32.mult_mod32(a, b, modulus, input_mod_factor)
        return K.mult_mod(a, b, modulus, input_mod_factor)
    return _launch("mult", word, a, b, q=modulus, s=(mu, 0, 0),
                   i=(shift, input_mod_factor))


def fma_mod(a: torch.Tensor, w: int, wp: int, c, modulus: int,
            input_mod_factor: int = 1, word: int = 64) -> torch.Tensor:
    """(a * w + c) mod q with w < q and its Shoup precondition wp (at
    2^64, or 2^32 for word 32); c a tensor or None; a, c < IMF*q."""
    if input_mod_factor not in (1, 2, 4, 8):
        raise ValueError("input_mod_factor must be 1, 2, 4 or 8")
    if not _on_card(a, c):
        fn = K32.fma_mod32_preconned if word == 32 else K.fma_mod_preconned
        return fn(a, w, wp, c, modulus, input_mod_factor)
    return _launch("fma", word, a, None, c, q=modulus, s=(w, wp, 0),
                   i=(0, input_mod_factor))


def reduce_mod(a: torch.Tensor, modulus: int, input_mod_factor: int,
               output_mod_factor: int, word: int = 64) -> torch.Tensor:
    """Range change: IMF in {2, 4, modulus} -> OMF in {1, 2}."""
    if output_mod_factor not in (1, 2):
        raise ValueError("output_mod_factor must be 1 or 2")
    if input_mod_factor == output_mod_factor:
        mode = 0
    elif input_mod_factor == modulus:
        mode = 1
    elif input_mod_factor in (2, 4):
        mode = input_mod_factor
    else:
        raise ValueError("input_mod_factor must be 2, 4, or == modulus")
    if not _on_card(a):
        fn = K32.reduce_mod32 if word == 32 else K.reduce_mod
        return fn(a, modulus, input_mod_factor, output_mod_factor)
    if word == 32:
        s = K32.mult_constants32(modulus) + (0,)
    else:
        s = (nt.barrett_factor(1, 64, modulus), 0, 0)
    return _launch("reduce", word, a, q=modulus, s=s,
                   i=(mode, output_mod_factor))


def cmp_add(a: torch.Tensor, cmp: str, bound: int, diff: int):
    """cmp(a, bound) ? a + diff : a, wrapping; compares unsigned."""
    code = K.cmp_code(cmp)
    if not _on_card(a):
        return K.cmp_add(a, cmp, bound, diff)
    return _launch("cmp_add", 64, a, s=(bound, diff, 0), i=(code, 0))


def cmp_sub_mod(a: torch.Tensor, modulus: int, cmp: str, bound: int,
                diff: int):
    """cmp(a, bound) ? (a mod q - diff) mod q : a mod q."""
    code = K.cmp_code(cmp)
    q_barr = nt.barrett_factor(1, 64, modulus)
    if not _on_card(a):
        return K.cmp_sub_mod(a, modulus, cmp, bound, diff)
    return _launch("cmp_sub", 64, a, q=modulus, s=(bound, diff, q_barr),
                   i=(code, 0))


def montgomery_form_in(a: torch.Tensor, modulus: int) -> torch.Tensor:
    """a * 2^64 mod q."""
    mu, shift = nt.barrett_mult_constants(modulus)
    if not _on_card(a):
        return K.montgomery_form_in(a, modulus)
    return _launch("mont_in", 64, a, q=modulus,
                   s=(mu, (1 << 64) % modulus, 0), i=(shift, 0))


def montgomery_form_out(a: torch.Tensor, modulus: int) -> torch.Tensor:
    """a * 2^-64 mod q."""
    inv = nt.hensel_lemma_2adic_root(64, modulus)
    if not _on_card(a):
        return K.montgomery_form_out(a, modulus)
    return _launch("mont_out", 64, a, q=modulus, s=(inv, 0, 0))


def montgomery_mult_reduce(a: torch.Tensor, b: torch.Tensor,
                           modulus: int) -> torch.Tensor:
    """REDC(a*b) = a * b * 2^-64 mod q for a, b in [0, q)."""
    inv = nt.hensel_lemma_2adic_root(64, modulus)
    if not _on_card(a, b):
        return K.montgomery_mult_reduce(a, b, modulus)
    return _launch("mont_mult", 64, a, b, q=modulus, s=(inv, 0, 0))


# -- the public functions ------------------------------------------------------

def _is_scalar(b) -> bool:
    return np.isscalar(b) or isinstance(b, int)


def _run(fn, vectors, device):
    """fn(*tensors) on the operands' device; numpy in, numpy out."""
    tensors, host = _device.operands(vectors, device)
    out = fn(*tensors)
    return to_numpy(out) if host else out


def eltwise_add_mod(a, b, modulus: int, device=None):
    """result[i] = (a[i] + b[i]) mod q; b may be a scalar. Inputs < q.

    int64 tensors of u64 bits run on their device; numpy uint64 operands
    run there too, else on `device` (default CUDA). The result is numpy iff
    an operand was numpy, as in the JAX package. So for every function
    below."""
    if _chk.debug_enabled():
        _chk.check(modulus > 1, "modulus must be > 1")
        _chk.check_bounds(a, modulus, "eltwise_add_mod operand1")
        if not _is_scalar(b):
            _chk.check_bounds(b, modulus, "eltwise_add_mod operand2")
    word = 32 if modulus < SMALL_Q else 64
    if _is_scalar(b):
        return _run(lambda x: add_mod(x, _u64(b), modulus, word), (a,),
                    device)
    return _run(lambda x, y: add_mod(x, y, modulus, word), (a, b), device)


def eltwise_sub_mod(a, b, modulus: int, device=None):
    """result[i] = (a[i] - b[i]) mod q; b may be a scalar. Inputs < q."""
    if _chk.debug_enabled():
        _chk.check(modulus > 1, "modulus must be > 1")
        _chk.check(modulus < (1 << 63), "modulus must be < 2^63")
        _chk.check_bounds(a, modulus, "eltwise_sub_mod operand1")
        if _is_scalar(b):
            _chk.check(int(b) < modulus,
                       "eltwise_sub_mod operand2 must be < modulus")
        else:
            _chk.check_bounds(b, modulus, "eltwise_sub_mod operand2")
    word = 32 if modulus < SMALL_Q else 64
    if _is_scalar(b):
        return _run(lambda x: sub_mod(x, _u64(b), modulus, word), (a,),
                    device)
    return _run(lambda x, y: sub_mod(x, y, modulus, word), (a, b), device)


def eltwise_mult_mod(a, b, modulus: int, input_mod_factor: int = 1,
                     device=None):
    """result[i] = (a[i] * b[i]) mod q; inputs < IMF*q, IMF in {1,2,4},
    q < 2^62; output in [0, q)."""
    if _chk.debug_enabled():
        _chk.check(input_mod_factor in (1, 2, 4),
                   "input_mod_factor must be 1, 2 or 4")
        _chk.check(input_mod_factor * modulus < (1 << 63),
                   "input_mod_factor * modulus must be < 2^63")
        _chk.check_bounds(a, input_mod_factor * modulus,
                          "eltwise_mult_mod operand1")
        _chk.check_bounds(b, input_mod_factor * modulus,
                          "eltwise_mult_mod operand2")
    small = modulus < SMALL_Q and input_mod_factor * modulus < (1 << 32)
    return _run(lambda x, y: mult_mod(x, y, modulus, input_mod_factor,
                                      32 if small else 64), (a, b), device)


def eltwise_fma_mod(arg1, arg2: int, arg3, modulus: int,
                    input_mod_factor: int = 1, device=None):
    """result[i] = (arg1[i] * arg2 + arg3[i]) mod q; arg3 may be None."""
    if _chk.debug_enabled():
        _chk.check(modulus > 1, "modulus must be > 1")
        _chk.check(modulus < (1 << 61), "modulus must be < 2^61")
        _chk.check(input_mod_factor in (1, 2, 4, 8),
                   "input_mod_factor must be 1, 2, 4 or 8")
        _chk.check(int(arg2) < input_mod_factor * modulus,
                   "arg2 exceeds input_mod_factor * modulus")
        _chk.check_bounds(arg1, input_mod_factor * modulus,
                          "eltwise_fma_mod arg1")
        if arg3 is not None:
            _chk.check_bounds(arg3, input_mod_factor * modulus,
                              "eltwise_fma_mod arg3")
    w = nt.reduce_mod(int(arg2), modulus, input_mod_factor)
    small = modulus < SMALL_Q and input_mod_factor * modulus < (1 << 32)
    word = 32 if small else 64
    wp = nt.barrett_factor(w, word, modulus)
    if arg3 is None:
        return _run(lambda x: fma_mod(x, w, wp, None, modulus,
                                      input_mod_factor, word), (arg1,),
                    device)
    return _run(lambda x, z: fma_mod(x, w, wp, z, modulus, input_mod_factor,
                                     word), (arg1, arg3), device)


def eltwise_reduce_mod(a, modulus: int, input_mod_factor: int,
                       output_mod_factor: int, device=None):
    """Range change: IMF in {2, 4, modulus} -> OMF in {1, 2}."""
    if _chk.debug_enabled():
        _chk.check(modulus > 1, "modulus must be > 1")
        _chk.check(input_mod_factor == modulus
                   or input_mod_factor in (2, 4),
                   "input_mod_factor must be modulus, 2 or 4")
        _chk.check(output_mod_factor in (1, 2),
                   "output_mod_factor must be 1 or 2")
        _chk.check(input_mod_factor != output_mod_factor,
                   "input_mod_factor must differ from output_mod_factor")
        if input_mod_factor != modulus:
            _chk.check_bounds(a, input_mod_factor * modulus,
                              "eltwise_reduce_mod operand")
    small = modulus < SMALL_Q and input_mod_factor in (2, 4)
    return _run(lambda x: reduce_mod(x, modulus, input_mod_factor,
                                     output_mod_factor, 32 if small else 64),
                (a,), device)


def eltwise_cmp_add(a, cmp: str, bound: int, diff: int, device=None):
    """result[i] = cmp(a[i], bound) ? a[i] + diff : a[i]."""
    if _chk.debug_enabled():
        _chk.check(int(diff) != 0, "diff must be != 0")
    return _run(lambda x: cmp_add(x, cmp, _u64(bound), _u64(diff)), (a,),
                device)


def eltwise_cmp_sub_mod(a, modulus: int, cmp: str, bound: int, diff: int,
                        device=None):
    """result[i] = cmp(a[i], bound) ? (a[i] - diff) mod q : a[i] mod q."""
    if _chk.debug_enabled():
        _chk.check(modulus > 1, "modulus must be > 1")
        _chk.check(int(diff) != 0, "diff must be != 0")
    return _run(lambda x: cmp_sub_mod(x, modulus, cmp, _u64(bound),
                                      _u64(diff)), (a,), device)


def eltwise_montgomery_form_in(a, modulus: int, device=None):
    """a * 2^64 mod q."""
    if _chk.debug_enabled():
        _chk.check(modulus > 1 and modulus % 2 == 1,
                   "modulus must be odd and > 1")
        _chk.check_bounds(a, modulus, "montgomery_form_in operand")
    return _run(lambda x: montgomery_form_in(x, modulus), (a,), device)


def eltwise_montgomery_form_out(a, modulus: int, device=None):
    """a * 2^-64 mod q."""
    if _chk.debug_enabled():
        _chk.check(modulus > 1 and modulus % 2 == 1,
                   "modulus must be odd and > 1")
        _chk.check_bounds(a, modulus, "montgomery_form_out operand")
    return _run(lambda x: montgomery_form_out(x, modulus), (a,), device)


def eltwise_montgomery_mult_reduce(a, b, modulus: int, device=None):
    """REDC(a*b) = a*b*2^-64 mod q for a, b in [0, q)."""
    if _chk.debug_enabled():
        _chk.check(modulus > 1 and modulus % 2 == 1,
                   "modulus must be odd and > 1")
        _chk.check_bounds(a, modulus, "montgomery_mult_reduce operand1")
        _chk.check_bounds(b, modulus, "montgomery_mult_reduce operand2")
    return _run(lambda x, y: montgomery_mult_reduce(x, y, modulus), (a, b),
                device)
