"""Exact modular products of int64 tensors for any q < 2^62, and the
float64 control.

`mulmod` splits each operand into two halves of h = ceil(bits / 2) bits,
so that every partial product fits in 63 bits, and shifts the high parts
back by at most 63 - bits bits a step, reducing after each, so that no
intermediate value reaches 2^63. Every result is in [0, q).

`mulmod_f64` is the control: the same product in float64, the precision
below the 64-bit words the configurations state. It loses the low bits of
every product above 2^53, so it gives wrong residues almost everywhere.
"""

from __future__ import annotations

import torch


def _shl_mod(x: torch.Tensor, k: int, q: torch.Tensor, step: int):
    """x * 2^k mod q for x in [0, q), `step` bits at a time."""
    while k > 0:
        s = min(step, k)
        x = (x << s) % q
        k -= s
    return x


def mulmod(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
           bits: int) -> torch.Tensor:
    """a * b mod q, exactly; a, b in [0, q), q < 2^bits <= 2^62, all
    broadcastable int64 tensors."""
    if not 2 <= bits <= 62:
        raise ValueError(f"moduli of {bits} bits are outside 2..62")
    h = (bits + 1) // 2
    step = 63 - bits
    mask = (1 << h) - 1
    a0, a1 = a & mask, a >> h
    b0, b1 = b & mask, b >> h
    hi = (a1 * b1) % q
    mid = ((a1 * b0) % q + (a0 * b1) % q) % q
    lo = (a0 * b0) % q
    r = (_shl_mod(hi, h, q, step) + mid) % q
    return (_shl_mod(r, h, q, step) + lo) % q


def mulmod_f64(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
               bits: int) -> torch.Tensor:
    """The control: a * b mod q computed in float64."""
    qd = q.to(torch.float64)
    r = torch.remainder(a.to(torch.float64) * b.to(torch.float64), qd)
    return r.to(torch.int64) % q
