"""Inputs made from the seed on the device."""

from __future__ import annotations

import torch


def uniform_rows(gen: torch.Generator, moduli, shape, axis: int,
                 device) -> torch.Tensor:
    """An int64 tensor of `shape` whose entries at index i of `axis` are
    uniform in [0, moduli[i]): one draw a modulus."""
    if shape[axis] != len(moduli):
        raise ValueError("axis length differs from the number of moduli")
    out = torch.empty(tuple(shape), dtype=torch.int64, device=device)
    rest = tuple(s for a, s in enumerate(shape) if a != axis)
    for i, q in enumerate(moduli):
        out.select(axis, i).copy_(torch.randint(
            0, int(q), rest, generator=gen, device=device))
    return out
