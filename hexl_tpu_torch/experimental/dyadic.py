"""Dyadic (ciphertext x ciphertext) multiply over an RNS basis, and the
wrapper of kernel K9 (`csrc/dyadic.cu`).

The counterpart of `hexl_tpu/experimental/dyadic.py`: two 2-polynomial
ciphertexts per modulus in NTT form give three polynomials per modulus,
(x0*y0, x0*y1 + x1*y0, x1*y1) mod q_i. `dyadic` also takes a leading
weights axis, summed in, which `lr_mat_vec_mult` uses. A tensor on the GPU
goes to K9 (its source note says what bounds it on an H100), a tensor on
the CPU to `dyadic_plain`. Where `config.approx_butterflies` is on for
the operands' device, the Barrett products take the approximate quotient,
as the JAX package's do where its switch is on (dyadic.py:46,74,
`limb.mult_mod_barrett_traced(..., approx)`; lr_mat_vec.py's `K.mult_mod`):
K9's instantiation on it (launch name "K9.approx") or the plain version
with `approx=True`. Every output is fully reduced, so it equals the JAX
package's bit for bit either way. Launches are counted under "K9".
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build, _device, config, nt
from ..limb import cond_sub64_half, mult_mod_barrett_rows, to_numpy, to_tensor
from ..ntt.plan import register_clear_hook
from ..utils import profiling

_P = ctypes.c_void_p
_ARGS = (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int, _P)


@functools.lru_cache(maxsize=None)
def row_constants(moduli: tuple, device: torch.device) -> torch.Tensor:
    """(3, M) int64 on `device`: q, mu and shift of each modulus's
    single-mulhi Barrett product (`nt.barrett_mult_constants`)."""
    mus, shifts = zip(*(nt.barrett_mult_constants(q) for q in moduli))
    return to_tensor(np.array([moduli, mus, shifts], dtype=np.uint64),
                     device)


register_clear_hook(row_constants.cache_clear)


def dyadic_plain(x: torch.Tensor, y: torch.Tensor, consts: torch.Tensor,
                 approx: bool = False) -> torch.Tensor:
    """The plain version: x, y (W, 2, M, n) -> (3, M, n), the dyadic
    products (with the approximate quotient where `approx`) summed over
    the weights by exact add_mods."""
    q, mu, shift = (consts[k].view(-1, 1) for k in range(3))

    def mm(a, b):
        return mult_mod_barrett_rows(a, b, q, mu, shift, approx)

    def add(a, b):
        return cond_sub64_half(a + b, q)

    acc = None
    for w in range(x.shape[0]):
        x0, x1, y0, y1 = x[w, 0], x[w, 1], y[w, 0], y[w, 1]
        prod = (mm(x0, y0), add(mm(x0, y1), mm(x1, y0)), mm(x1, y1))
        acc = prod if acc is None else tuple(map(add, acc, prod))
    return torch.stack(acc)


def _checked(x: torch.Tensor, y: torch.Tensor, moduli) -> tuple:
    """`dyadic`'s checks of the operands' shapes and of the moduli, which
    it returns as a tuple of ints."""
    moduli = tuple(int(q) for q in moduli)
    if x.shape != y.shape or x.dim() != 4 or x.shape[1] != 2 \
            or x.shape[2] != len(moduli) or x.shape[0] < 1:
        raise ValueError(f"operands must both have shape (W, 2, "
                         f"{len(moduli)}, n), got {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    for q in moduli:
        if not 2 < q < (1 << 62):
            raise ValueError("moduli must be in (2, 2^62)")
    return moduli


def dyadic(x: torch.Tensor, y: torch.Tensor, moduli) -> torch.Tensor:
    """sum over w of the dyadic products of x[w] and y[w], (W, 2, M, n)
    each, mod moduli[m] along M: K9 on the GPU, the plain version on the
    CPU; the Barrett quotient approximate where `config.approx_butterflies`
    is on for x's device."""
    return _dyadic(x, y, _checked(x, y, moduli))


def _dyadic(x: torch.Tensor, y: torch.Tensor, moduli: tuple
            ) -> torch.Tensor:
    """`dyadic` on operands and moduli that passed its checks."""
    consts = row_constants(moduli, x.device)
    approx = config.approx_butterflies(x.device)
    if not _build.on_card(x, y):
        return dyadic_plain(x, y, consts, approx)
    weights, _, m, n = x.shape
    out = torch.empty((3, m, n), dtype=torch.int64, device=x.device)
    if n == 0:
        return out
    fn = _build.function("dyadic", "hexl_dyadic", _ARGS)
    _build.launch_on(x.device, "K9.approx" if approx else "K9", fn,
                     x.data_ptr(), y.data_ptr(), out.data_ptr(),
                     consts.data_ptr(), weights, m, n, int(approx))
    return out


def dyadic_multiply(operand1, operand2, moduli, device=None):
    """ct x ct product. Operands shaped (2, num_moduli, n), output
    (3, num_moduli, n), in the input's modulus order; values < q_i along
    the moduli axis.

    int64 tensors of u64 bits run on their device; numpy uint64 operands
    run there too, else on `device` (default CUDA). The result is numpy iff
    an operand was numpy, as in the JAX package."""
    if not profiling.on():
        (x, y), host = _device.operands((operand1, operand2), device)
        x, y = x.unsqueeze(0), y.unsqueeze(0)
        out = _dyadic(x, y, _checked(x, y, moduli))
        return to_numpy(out) if host else out
    with profiling.Span("hexl.dyadic_multiply"):
        with profiling.Span(profiling.CHECKS):
            (x, y), host = _device.operands((operand1, operand2), device)
        x, y = x.unsqueeze(0), y.unsqueeze(0)
        with profiling.Span("hexl.dyadic"):
            with profiling.Span(profiling.CHECKS):
                moduli = _checked(x, y, moduli)
            out = _dyadic(x, y, moduli)
        return to_numpy(out) if host else out
