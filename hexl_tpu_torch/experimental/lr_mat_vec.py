"""Encrypted linear-regression matrix-vector multiply.

The counterpart of `hexl_tpu/experimental/lr_mat_vec.py`: the dyadic
product of each weight's ciphertext pair, summed over the weights. The JAX
package sums by an adder tree of exact add_mods of fully reduced values,
so any order gives the same bits: here the sum runs inside one launch of
K9 (`dyadic.dyadic` with the weights axis), or its plain version on the
CPU, with the approximate Barrett quotient where `config.approx_butterflies`
is on, as the JAX package's `K.mult_mod` takes it where its switch is on.
"""

from __future__ import annotations

from .. import _device
from ..limb import to_numpy
from .dyadic import dyadic


def lr_mat_vec_mult(cipher1, cipher2, moduli, device=None):
    """result = sum over w of cipher1[w] (x) cipher2[w] (dyadic, mod-q
    pointwise). cipher1, cipher2: (num_weights, 2, num_moduli, n) in NTT
    form; returns (3, num_moduli, n). Operands and devices as in
    `dyadic_multiply`."""
    (c1, c2), host = _device.operands((cipher1, cipher2), device)
    out = dyadic(c1, c2, moduli)
    return to_numpy(out) if host else out
