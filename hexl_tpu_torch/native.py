"""ctypes bindings of the port's host library (`csrc/host.cpp`).

Plan construction (the twiddle tables, prime generation, primitive roots)
is host work of O(N log q); the C++ library does it at native speed. `g++`
builds it into `build/hexl_tpu_torch/<hash>/libhost.so` at first use
(`_build.build_host`, under the kernels' build lock); a failed build
raises. Only HEXL_TPU_DISABLE_NATIVE (`config.native_disabled`) makes
these functions answer None, and the callers (`nt`, `ntt/plan.py`) then
compute in Python integers, their plain versions. Each function also
answers None where the library's 64-bit arithmetic does not reach, as in
the JAX package's `native.py`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import _build, config

_LIB = None
_LOCK = threading.Lock()

_U64 = ctypes.c_uint64
_P64 = ctypes.POINTER(ctypes.c_uint64)


def _load():
    """The loaded library, or None when HEXL_TPU_DISABLE_NATIVE is set."""
    global _LIB
    if config.native_disabled():
        return None
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(_build.build_host()))
                lib.ht_is_prime.restype = ctypes.c_int
                lib.ht_is_prime.argtypes = [_U64]
                lib.ht_generate_primes.restype = ctypes.c_int64
                lib.ht_generate_primes.argtypes = [
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _U64, _P64]
                lib.ht_minimal_primitive_root.restype = _U64
                lib.ht_minimal_primitive_root.argtypes = [_U64, _U64]
                lib.ht_inverse_mod.restype = _U64
                lib.ht_inverse_mod.argtypes = [_U64, _U64]
                lib.ht_root_tables.restype = ctypes.c_int
                lib.ht_root_tables.argtypes = [_U64, _U64, _U64, _P64, _P64,
                                               _P64, _P64]
                _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P64)


def available() -> bool:
    """True unless HEXL_TPU_DISABLE_NATIVE is set (building the library on
    first use, and raising if that fails)."""
    return _load() is not None


def is_prime(n: int):
    lib = _load()
    if lib is None or not 0 <= n < (1 << 64):
        return None
    return bool(lib.ht_is_prime(n))


def generate_primes(num: int, bit_size: int, prefer_small: bool,
                    ntt_size: int):
    """The first `num` primes of the scan, or None where the library cannot
    answer (63 bits and more, or fewer primes than asked: the caller's
    Python scan then raises)."""
    lib = _load()
    if lib is None or bit_size >= 63:
        return None
    out = np.zeros(num, dtype=np.uint64)
    found = lib.ht_generate_primes(num, bit_size, int(prefer_small),
                                   ntt_size, _ptr(out))
    if found < num:
        return None
    return [int(x) for x in out]


def minimal_primitive_root(degree: int, modulus: int):
    lib = _load()
    if lib is None or not 0 < modulus < (1 << 64):
        return None
    r = int(lib.ht_minimal_primitive_root(degree, modulus))
    return r if r != 0 else None


def root_tables(n: int, modulus: int, root: int):
    """(rop, irop, prop, pirop) as numpy uint64 arrays of n entries: rop
    the bit-reversed powers of root, irop the stage-major inverse table,
    prop/pirop their Shoup preconditions at 2^64; or None."""
    lib = _load()
    if lib is None:
        return None
    tables = [np.zeros(n, dtype=np.uint64) for _ in range(4)]
    lib.ht_root_tables(n, modulus, root, *(_ptr(t) for t in tables))
    return tuple(tables)
