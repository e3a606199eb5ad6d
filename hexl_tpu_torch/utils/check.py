"""Debug-only input validation: the port's copy of `hexl_tpu/utils/check.py`.

Checks are no-ops unless debug mode is on (`HEXL_TPU_DEBUG=1`), as in the
reference library, whose release builds validate nothing. In debug mode a
bound check reads every value: a tensor on the card is copied to the host
for it, which costs a synchronisation, and only then.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..limb import to_numpy


def debug_enabled() -> bool:
    return config.debug_checks()


def check(cond: bool, message: str) -> None:
    """Raise ValueError(message) when debug mode is on and cond is false."""
    if debug_enabled() and not cond:
        raise ValueError(message)


def check_bounds(values, bound: int, message: str) -> None:
    """Check that every element (u64 bits) is < bound, in debug mode only."""
    if not debug_enabled():
        return
    if isinstance(values, torch.Tensor):
        arr = to_numpy(values)
    else:
        arr = np.asarray(values, dtype=np.uint64)
    if arr.size and int(arr.max()) >= bound:
        raise ValueError(f"{message}: max value {int(arr.max())} "
                         f">= bound {bound}")


def check_row_bounds(values, bounds, message: str) -> None:
    """`check_bounds` of row i of values against bounds[i], the message
    naming the row as "(prime i)", in debug mode only."""
    if not debug_enabled():
        return
    if isinstance(values, torch.Tensor):
        values = to_numpy(values)
    for i, bound in enumerate(bounds):
        check_bounds(values[i], bound, f"{message} (prime {i})")
