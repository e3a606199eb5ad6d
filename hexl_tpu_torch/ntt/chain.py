"""K17: a chain of dependent NTT forward butterflies, and its plain version.

The port of the TPU kernel of `benchmarks/mosaic_butterfly_ab.py` (its
pallas_call at :93): REPS dependent lean16 forward butterflies
(`hexl_tpu/ntt/jnp_ntt.py::_fwd_butterfly_lean16`, the hot loop of the JAX
engine's approximate device bodies) on two planes x, y of u64 residues
with one twiddle, its precondition and q, the outputs swapped after each
butterfly. `scheme="exact"` runs the same chain with the exact Harvey
butterfly of K1: the two together say what the approximate quotient buys
on the card. The probe's shape is two 16384 x 128 planes, REPS = 8,
q = 2^59 - 2^14 + 1 and w = 0x0123456789ABCDE5 mod q (`probe_inputs`).

On the GPU `chain` launches K17 (`csrc/chain.cu`); on the CPU it runs
`chain_plain`, the butterflies of `torch_ntt` (bit-exact against the JAX
function). Launches are counted in `_build.launches` under "K17" (lean16)
and "K17.exact".
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..limb import s64, to_tensor
from . import torch_ntt

REPS = 8
ROWS, LANES = 16384, 128
PROBE_Q = (1 << 59) - (1 << 14) + 1
PROBE_W = 0x0123456789ABCDE5 % PROBE_Q

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_ARGS = (_P, _P, _P, _P, _U, _U, _U, ctypes.c_int, ctypes.c_longlong,
         ctypes.c_int, _P)


def kernel_name(scheme: str) -> str:
    """"K17" for the probe's lean16 chain, "K17.exact" for its sibling."""
    return "K17" if scheme == "lean16" else "K17.exact"


def precondition(w: int, q: int) -> int:
    """floor(w 2^64 / q), the Shoup precondition of w."""
    return (w << 64) // q


def probe_inputs(rng: np.random.Generator, device, rows: int = ROWS,
                 lanes: int = LANES):
    """The probe's operands: x, y uniform in [0, q) as (rows, lanes) planes
    on `device`, from `rng` (the probe's own data come from
    np.random.default_rng(0))."""
    x, y = (to_tensor(rng.integers(0, PROBE_Q, size=rows * lanes,
                                   dtype=np.uint64).reshape(rows, lanes),
                      device) for _ in range(2))
    return x, y


def _check(scheme: str, q: int) -> None:
    if scheme not in ("lean16", "exact"):
        raise ValueError(f"scheme must be 'lean16' or 'exact', got {scheme!r}")
    torch_ntt.check_scheme(scheme, q)


def chain_plain(x: torch.Tensor, y: torch.Tensor, w: int, q: int,
                reps: int = REPS, scheme: str = "lean16") -> tuple:
    """`reps` butterflies of `scheme` on (x, y), swapping after each."""
    _check(scheme, q)
    wp = s64(precondition(w, q))
    for _ in range(reps):
        nx, ny = torch_ntt.fwd_butterfly(x, y, w, wp, q, scheme)
        x, y = ny, nx
    return x, y


def chain(x: torch.Tensor, y: torch.Tensor, w: int, q: int, reps: int = REPS,
          scheme: str = "lean16") -> tuple:
    """The chain on int64 tensors of u64 bits of one shape: K17 on the GPU,
    `chain_plain` on the CPU. Inputs: lean16 [0, 16q), exact [0, 4q)."""
    _check(scheme, q)
    if x.shape != y.shape:
        raise ValueError("x and y must have one shape")
    if not 0 <= w < q:
        raise ValueError("the twiddle must lie in [0, q)")
    if not _build.on_card(x, y):
        return chain_plain(x, y, w, q, reps, scheme)
    ox, oy = torch.empty_like(x), torch.empty_like(y)
    if x.numel() == 0:
        return ox, oy
    fn = _build.function("chain", "hexl_ntt_chain", _ARGS)
    _build.launch_on(x.device, kernel_name(scheme), fn, x.data_ptr(),
                     y.data_ptr(), ox.data_ptr(), oy.data_ptr(), w,
                     precondition(w, q), q, reps, x.numel(),
                     torch_ntt.SCHEME_CODE[scheme])
    return ox, oy
