"""NTT plan: per-(N, q) twiddle tables, their constants and device copies.

The counterpart of `hexl_tpu/ntt/plan.py`, keeping only what the flat walk
needs: the bit-reversed forward table `rop`, the stage-major inverse table
`irop`, their Shoup preconditions `prop`/`pirop`, and the constants of the
final inverse stage fused with N^-1. For q < 2^30 (`bit_shift` 32) it adds
the single-word regime's preconditions at 2^32, `prop32`/`pirop32` and
`inv_n_precon32`/`inv_n_w_precon32` (JAX plan.py:220-237). (The JAX plan's
TPU layouts, the phase A/B stage split at stride 128, its tile tables and
the per-shard stacked copies of `hier.HierTables`, have no counterpart:
every walk reads the flat tables, a shard at its offset in them.)

The twiddle tables are HEXL's only state, the role weights play in a model;
`NttPlan(N, q)` takes them from the host library (`native.root_tables`,
built with g++; the Python tables below are the plain versions, taken with
HEXL_TPU_DISABLE_NATIVE set), `plan_from_arrays` carries them over from
another plan's host arrays, and `save_plan_cache`/`load_plan_cache` keep
them on disk in the JAX package's `.npz` format, so a file written by
either package loads in the other. Everything else is derived from them.

The cache (`get_plan`) holds one plan per (N, q); `clear_plan_cache` drops
it and runs the hooks (`register_clear_hook`) that flush every derived
cache holding a plan or its device tables.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .. import native, nt
from ..limb import to_tensor

MAX_DEGREE = 1 << 20
MAX_MODULUS = 1 << 62
MIN_2D_N = 1024          # the JAX plan's 2-D tables, and its q < 2^30 regime
SINGLE_WORD_Q = 1 << 30  # below it, 4q < 2^32: one u32 word per coefficient


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


def _powers(base: int, n: int, modulus: int) -> np.ndarray:
    """[base^i mod q for i < n] as uint64, by doubling in Python integers."""
    out = np.empty(n, dtype=object)
    out[0] = 1
    filled, step = 1, base % modulus
    while filled < n:
        out[filled:2 * filled] = out[:filled] * step % modulus
        step = step * step % modulus
        filled *= 2
    return out.astype(np.uint64)


def bit_reversed_indices(n: int) -> np.ndarray:
    bits = nt.log2_exact(n)
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def root_of_unity_powers(n: int, modulus: int, root: int):
    """(rop, irop): rop[bit_reverse(i)] = w^i, and irop the stage-major
    reordering of w^-i at bit-reversed index (the inverse walk reads it
    sequentially)."""
    rev = bit_reversed_indices(n)
    rop = np.zeros(n, dtype=np.uint64)
    irop_raw = np.zeros(n, dtype=np.uint64)
    rop[rev] = _powers(root, n, modulus)
    irop_raw[rev] = _powers(nt.inverse_mod(root, modulus), n, modulus)
    irop = np.zeros(n, dtype=np.uint64)
    irop[0] = irop_raw[0]
    idx = 1
    m = n >> 1
    while m > 0:
        irop[idx:idx + m] = irop_raw[m:2 * m]
        idx += m
        m >>= 1
    return rop, irop


def precon(values: np.ndarray, modulus: int, bit_shift: int) -> np.ndarray:
    """floor(v << bit_shift / q) for each table entry (Shoup
    preconditioning; v < q, so the result fits 64 bits)."""
    wide = np.asarray(values, dtype=np.uint64).astype(object)
    return ((wide << bit_shift) // modulus).astype(np.uint64)


class NttPlan:
    """Twiddle tables and derived constants for one (N, q) pair.

    Host tables are numpy uint64; `tables(device)` gives int64 tensors of
    the same bits on a device, copied once per device."""

    def __init__(self, degree: int, modulus: int, root: int | None = None,
                 device=None):
        """The JAX plan's constructor: check (N, q), take the minimal
        primitive 2N-th root when none is given (refusing one that is not
        primitive), build the tables, and with `device` copy them there."""
        check_arguments(degree, modulus)
        if root is None:
            root = nt.minimal_primitive_root(2 * degree, modulus)
        elif not nt.is_primitive_root(root, 2 * degree, modulus):
            raise ValueError(f"{root} is not a primitive {2 * degree}-th "
                             f"root of unity mod {modulus}")
        tables = native.root_tables(degree, modulus, root)
        if tables is not None:
            rop, irop, prop, pirop = tables
        else:
            rop, irop = root_of_unity_powers(degree, modulus, root)
            prop, pirop = precon(rop, modulus, 64), precon(irop, modulus, 64)
        self._set_tables(degree, modulus, root, rop, prop, irop, pirop)
        if device is not None:
            self.tables(device)

    @classmethod
    def from_tables(cls, degree: int, modulus: int, root: int, rop, prop,
                    irop, pirop) -> "NttPlan":
        """A plan of host tables already computed (unchecked: see
        `plan_from_arrays` for the checked form)."""
        plan = cls.__new__(cls)
        plan._set_tables(degree, modulus, root, rop, prop, irop, pirop)
        return plan

    @classmethod
    def build(cls, degree: int, modulus: int, root: int | None = None
              ) -> "NttPlan":
        return cls(degree, modulus, root)

    def _set_tables(self, degree, modulus, root, rop, prop, irop, pirop):
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
        # For q < 2^30 every lazy value (< 4q) fits one u32 word: the same
        # twiddles preconditioned at 2^32 (JAX plan.py:220-237).
        self.bit_shift = 32 if modulus < SINGLE_WORD_Q else 64
        if self.bit_shift == 32:
            self.prop32 = precon(rop, modulus, 32)
            self.pirop32 = precon(irop, modulus, 32)
            self.inv_n_precon32 = (self.inv_n << 32) // modulus
            self.inv_n_w_precon32 = (self.inv_n_w << 32) // modulus
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}
        self._dev_lock = threading.Lock()

    @property
    def single_word(self) -> bool:
        """The JAX engine's dispatch rule (`ntt/__init__.py::_use_32bit`):
        q < 2^30 with N >= 1024 runs the single-word transform, whose lazy
        outputs differ in value from the 64-bit walk's."""
        return self.bit_shift == 32 and self.n >= MIN_2D_N

    def tables(self, device) -> Dict[str, torch.Tensor]:
        """rop, prop, irop, pirop (and prop32, pirop32 for q < 2^30) as
        int64 tensors on `device`."""
        key = str(torch.device(device))
        tabs = self._dev.get(key)
        if tabs is None:
            with self._dev_lock:
                tabs = self._dev.get(key)
                if tabs is None:
                    names = ["rop", "prop", "irop", "pirop"]
                    if self.bit_shift == 32:
                        names += ["prop32", "pirop32"]
                    tabs = {name: to_tensor(getattr(self, name), device)
                            for name in names}
                    self._dev[key] = tabs
        return tabs

    def twiddles(self, device, forward: bool, word: int = 64):
        """(w, w_precon) device tables of one direction for the 64-bit
        walk (word 64) or the single-word walk (word 32)."""
        tabs = self.tables(device)
        suffix = "32" if word == 32 else ""
        if forward:
            return tabs["rop"], tabs["prop" + suffix]
        return tabs["irop"], tabs["pirop" + suffix]

    def fin(self, word: int = 64) -> Tuple[int, int, int, int]:
        """(inv_n, inv_n_precon, inv_n_w, inv_n_w_precon) of the final
        inverse stage, preconditioned for `word`."""
        if word == 32:
            return (self.inv_n, self.inv_n_precon32, self.inv_n_w,
                    self.inv_n_w_precon32)
        return (self.inv_n, self.inv_n_precon, self.inv_n_w,
                self.inv_n_w_precon)


def plan_from_arrays(degree: int, modulus: int, root: int, rop, prop, irop,
                     pirop) -> NttPlan:
    """A plan from host tables computed elsewhere (e.g. the JAX package's
    `NttPlan.rop/prop/irop/pirop`, or a plan file), without recomputing
    them.

    The arguments and root are checked, and the tables spot-checked against
    the root at entries 1, N/2 and N-1, as the JAX package's
    `load_plan_cache` does and with its messages, so a table of another
    (N, q, root) is refused. The single-word preconditions of q < 2^30 are
    derived from rop/irop."""
    check_arguments(degree, modulus)
    root = int(root)
    if not nt.is_primitive_root(root, 2 * degree, modulus):
        raise ValueError(f"stored root {root} is not a primitive "
                         f"{2 * degree}-th root of unity mod {modulus}")
    where = f"(N={degree}, q={modulus})"
    arrays = [np.ascontiguousarray(np.asarray(t, dtype=np.uint64))
              for t in (rop, prop, irop, pirop)]
    if any(a.shape != (degree,) for a in arrays):
        raise ValueError(f"corrupt plan tables for {where}")
    rop, prop, irop, pirop = arrays
    bits = nt.log2_exact(degree)
    root_inv = nt.inverse_mod(root, modulus)
    for i in {1 % degree, degree // 2, degree - 1}:
        w = pow(root, nt.reverse_bits(i, bits), modulus)
        if int(rop[i]) != w:
            raise ValueError(f"corrupt rop table for {where}")
        if int(prop[i]) != (w << 64) // modulus:
            raise ValueError(f"corrupt prop table for {where}")
        iv = int(irop[i])
        if iv >= modulus or int(pirop[i]) != (iv << 64) // modulus:
            raise ValueError(f"corrupt irop table for {where}")
    if int(irop[degree - 1]) != pow(root_inv, degree // 2, modulus):
        raise ValueError(f"corrupt irop table for {where}")
    return NttPlan.from_tables(degree, modulus, root, rop, prop, irop,
                               pirop)


# -- the cache, its hooks and its disk form ------------------------------------

_PLAN_CACHE: Dict[Tuple[int, int], NttPlan] = {}
_CACHE_LOCK = threading.Lock()

# Run by clear_plan_cache() after the plans are dropped, so that every
# derived cache holding a plan or its device tables (the MXU plans, the
# shards' twiddles, the composites' constants) is flushed with them.
_CLEAR_HOOKS: List[Callable[[], None]] = []


def register_clear_hook(fn: Callable[[], None]) -> None:
    _CLEAR_HOOKS.append(fn)


def get_plan(degree: int, modulus: int, device=None) -> NttPlan:
    """The cached plan of (N, q), built on first use. With a device, its
    tables are also copied there (`NttPlan.tables`); the plan is the same
    one either way, and the device is not part of what is saved."""
    key = (degree, modulus)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        with _CACHE_LOCK:
            plan = _PLAN_CACHE.get(key)
            if plan is None:
                plan = NttPlan(degree, modulus)
                _PLAN_CACHE[key] = plan
    if device is not None:
        plan.tables(device)
    return plan


def clear_plan_cache() -> None:
    """Drop every cached plan, then run the registered hooks."""
    with _CACHE_LOCK:
        _PLAN_CACHE.clear()
    for fn in _CLEAR_HOOKS:
        fn()


def save_plan_cache(path: str) -> int:
    """Write every cached plan's host tables to `path` (.npz) and return
    the number of (N, q) pairs saved.

    The JAX package's format: per (N, q), `rop_{N}_{q}`, `irop_`, `prop_`
    and `pirop_` (uint64 arrays) and `root_{N}_{q}` (a uint64 scalar).
    Device copies are not saved."""
    with _CACHE_LOCK:
        plans = list(_PLAN_CACHE.values())
    arrays = {}
    for plan in plans:
        key = f"{plan.n}_{plan.q}"
        arrays[f"rop_{key}"] = plan.rop
        arrays[f"irop_{key}"] = plan.irop
        arrays[f"prop_{key}"] = plan.prop
        arrays[f"pirop_{key}"] = plan.pirop
        arrays[f"root_{key}"] = np.uint64(plan.root)
    np.savez_compressed(path, **arrays)
    return len(plans)


def load_plan_cache(path: str) -> int:
    """Restore the plans of a file written by `save_plan_cache` (of this
    package or of the JAX package) into the cache; returns the number
    loaded.

    Each plan is checked as `plan_from_arrays` checks it (the arguments,
    the root, the table shapes and spot entries) and refused with the JAX
    package's ValueError otherwise; beyond that the file is trusted, like
    any other precomputed key material."""
    with np.load(path) as data:
        keys = sorted({tuple(int(v) for v in name[len("rop_"):].split("_"))
                       for name in data.files if name.startswith("rop_")})
        plans = []
        for n, q in keys:
            key = f"{n}_{q}"
            plans.append(plan_from_arrays(
                n, q, int(data[f"root_{key}"]), data[f"rop_{key}"],
                data[f"prop_{key}"], data[f"irop_{key}"],
                data[f"pirop_{key}"]))
    with _CACHE_LOCK:
        for plan in plans:
            _PLAN_CACHE[(plan.n, plan.q)] = plan
    return len(plans)
