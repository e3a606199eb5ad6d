"""NTT plan: per-(N, q) twiddle tables, their constants and device copies.

The counterpart of `hexl_tpu/ntt/plan.py`, keeping only what the flat walk
needs: the bit-reversed forward table `rop`, the stage-major inverse table
`irop`, their Shoup preconditions `prop`/`pirop`, and the constants of the
final inverse stage fused with N^-1. (The JAX plan's TPU layouts, the phase
A/B stage split at stride 128 and its tile tables, have no counterpart.)

The twiddle tables are HEXL's only state, the role weights play in a model;
`plan_from_arrays` carries them over from another plan's host arrays.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .. import nt
from ..limb import to_tensor

MAX_DEGREE = 1 << 20
MAX_MODULUS = 1 << 62


def check_arguments(degree: int, modulus: int) -> None:
    """Same constraints as the JAX plan (and the reference engine)."""
    if not nt.is_power_of_two(degree):
        raise ValueError(f"degree {degree} must be a power of two")
    if degree > MAX_DEGREE:
        raise ValueError(f"degree {degree} exceeds max {MAX_DEGREE}")
    if modulus > MAX_MODULUS:
        raise ValueError("modulus must be <= 2^62")
    if modulus % (2 * degree) != 1:
        raise ValueError("modulus must satisfy q = 1 mod 2N")
    if not nt.is_prime(modulus):
        raise ValueError("modulus must be prime")


def root_of_unity_powers(n: int, modulus: int, root: int):
    """(rop, irop): rop[bit_reverse(i)] = w^i, and irop the stage-major
    reordering of w^-i at bit-reversed index (the inverse walk reads it
    sequentially)."""
    bits = nt.log2_exact(n)
    rop = np.zeros(n, dtype=np.uint64)
    irop_raw = np.zeros(n, dtype=np.uint64)
    root_inv = nt.inverse_mod(root, modulus)
    power = inv_power = 1
    for i in range(n):
        idx = nt.reverse_bits(i, bits)
        rop[idx] = power
        irop_raw[idx] = inv_power
        power = (power * root) % modulus
        inv_power = (inv_power * root_inv) % modulus
    irop = np.zeros(n, dtype=np.uint64)
    irop[0] = irop_raw[0]
    idx = 1
    m = n >> 1
    while m > 0:
        irop[idx:idx + m] = irop_raw[m:2 * m]
        idx += m
        m >>= 1
    return rop, irop


def precon64(values: np.ndarray, modulus: int) -> np.ndarray:
    """floor(v << 64 / q) for each table entry (Shoup preconditioning)."""
    return np.array([nt.barrett_factor(int(v), 64, modulus) for v in values],
                    dtype=np.uint64)


class NttPlan:
    """Twiddle tables and derived constants for one (N, q) pair.

    Host tables are numpy uint64; `tables(device)` gives int64 tensors of
    the same bits on a device, copied once per device."""

    def __init__(self, degree: int, modulus: int, root: int, rop, prop, irop,
                 pirop):
        self.n = degree
        self.q = modulus
        self.log_n = nt.log2_exact(degree)
        self.root = root
        self.rop, self.prop, self.irop, self.pirop = rop, prop, irop, pirop
        # Final-inverse-stage constants (N^-1 folded into the last stage).
        self.inv_n = nt.inverse_mod(degree, modulus)
        self.inv_n_precon = nt.barrett_factor(self.inv_n, 64, modulus)
        self.inv_n_w = (self.inv_n * int(irop[degree - 1])) % modulus
        self.inv_n_w_precon = nt.barrett_factor(self.inv_n_w, 64, modulus)
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}
        self._dev_lock = threading.Lock()

    @classmethod
    def build(cls, degree: int, modulus: int, root: int | None = None
              ) -> "NttPlan":
        check_arguments(degree, modulus)
        if root is None:
            root = nt.minimal_primitive_root(2 * degree, modulus)
        elif not nt.is_primitive_root(root, 2 * degree, modulus):
            raise ValueError(f"{root} is not a primitive {2 * degree}-th "
                             f"root of unity mod {modulus}")
        rop, irop = root_of_unity_powers(degree, modulus, root)
        return cls(degree, modulus, root, rop, precon64(rop, modulus), irop,
                   precon64(irop, modulus))

    def tables(self, device) -> Dict[str, torch.Tensor]:
        """rop, prop, irop, pirop as int64 tensors on `device`."""
        key = str(torch.device(device))
        tabs = self._dev.get(key)
        if tabs is None:
            with self._dev_lock:
                tabs = self._dev.get(key)
                if tabs is None:
                    tabs = {name: to_tensor(getattr(self, name), device)
                            for name in ("rop", "prop", "irop", "pirop")}
                    self._dev[key] = tabs
        return tabs


def plan_from_arrays(degree: int, modulus: int, root: int, rop, prop, irop,
                     pirop) -> NttPlan:
    """A plan from host tables computed elsewhere (e.g. the JAX package's
    `NttPlan.rop/prop/irop/pirop`), without recomputing them.

    The arguments and root are checked, and the tables spot-checked against
    the root, so a table of another (N, q, root) is refused."""
    check_arguments(degree, modulus)
    root = int(root)
    if not nt.is_primitive_root(root, 2 * degree, modulus):
        raise ValueError(f"{root} is not a primitive {2 * degree}-th root "
                         f"of unity mod {modulus}")
    arrays = [np.ascontiguousarray(np.asarray(t, dtype=np.uint64))
              for t in (rop, prop, irop, pirop)]
    if any(a.shape != (degree,) for a in arrays):
        raise ValueError(f"tables must have shape ({degree},)")
    rop, prop, irop, pirop = arrays
    bits = nt.log2_exact(degree)
    root_inv = nt.inverse_mod(root, modulus)
    for i in {1 % degree, degree // 2, degree - 1}:
        w = pow(root, nt.reverse_bits(i, bits), modulus)
        if int(rop[i]) != w or int(prop[i]) != (w << 64) // modulus:
            raise ValueError(f"rop/prop do not match root {root}")
        iv = int(irop[i])
        if iv >= modulus or int(pirop[i]) != (iv << 64) // modulus:
            raise ValueError("irop/pirop are inconsistent")
    if int(irop[degree - 1]) != pow(root_inv, degree // 2, modulus):
        raise ValueError(f"irop does not match root {root}")
    return NttPlan(degree, modulus, root, rop, prop, irop, pirop)


_PLAN_CACHE: Dict[Tuple[int, int], NttPlan] = {}
_CACHE_LOCK = threading.Lock()


def get_plan(degree: int, modulus: int) -> NttPlan:
    """The cached plan of (N, q), built on first use."""
    key = (degree, modulus)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        with _CACHE_LOCK:
            plan = _PLAN_CACHE.get(key)
            if plan is None:
                plan = NttPlan.build(degree, modulus)
                _PLAN_CACHE[key] = plan
    return plan


def clear_plan_cache() -> None:
    with _CACHE_LOCK:
        _PLAN_CACHE.clear()
