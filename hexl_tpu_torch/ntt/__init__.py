"""Negacyclic NTT over Z_q[X]/(X^N + 1): the public engine.

Usage parity with `hexl_tpu.ntt.NTT`:

    ntt = NTT(degree=4096, modulus=q)          # on the GPU
    y = ntt.forward(x, input_mod_factor=1, output_mod_factor=1)
    x = ntt.inverse(y, input_mod_factor=1, output_mod_factor=1)

The output of `forward` is in bit-reversed order, with the same lazy ranges
and values as the JAX package, because the routing is the JAX engine's:
q < 2^30 with N >= 1024 runs the single-word transform (`cuda_ntt` with
word 32: K7, or the u32 two-pass split above 2^15), everything else the
64-bit walk (K1/K2 up to 2^14, the two-pass split K5/K6 above). The
64-bit walk runs the approximate-quotient butterflies of the JAX engine's
device bodies (lean16/lean8, `torch_ntt.scheme_for`) where
`config.approx_butterflies(device)` says so, and the exact Harvey ones
elsewhere: fully reduced outputs are the same bits, lazy ones agree mod q
within the same ranges. Under HEXL_TPU_DEBUG=1 every input is checked
below IMF x q, as in the JAX engine. Inputs
have shape (..., N): numpy uint64 in gives numpy out; an int64 tensor of
u64 bits in gives a tensor out on its device.

The four-step matmul regime (`mxu_ntt`: `get_mxu_plan`, `fwd_ntt_mxu`,
`inv_ntt_mxu`, N from 2^8 to 2^18) computes the same fully reduced
transform for the same root; its lazy outputs are its own.
"""

from __future__ import annotations

import numpy as np

from .. import _device
from ..limb import to_numpy
from ..utils import check as _check
from . import cuda_ntt, mxu_ntt, torch_ntt
from . import plan as _plan
from .mxu_ntt import fwd_ntt_mxu, get_mxu_plan, inv_ntt_mxu
from .plan import NttPlan, check_arguments, get_plan, plan_from_arrays
from .rns import RnsNTT, get_rns_plan

__all__ = ["NTT", "NttPlan", "get_plan", "clear_plan_cache",
           "check_arguments", "plan_from_arrays", "RnsNTT", "get_rns_plan",
           "get_mxu_plan", "fwd_ntt_mxu", "inv_ntt_mxu"]


def clear_plan_cache() -> None:
    """Drop every cached plan, the MXU plans included."""
    _plan.clear_plan_cache()
    mxu_ntt.clear_mxu_cache()


class NTT:
    """Per-(N, q) transform engine; construction precomputes twiddles.

    device: where numpy inputs run (default CUDA, which must be present);
    tensor inputs run on their own device. Every power-of-two N from 2 to
    2^20 and every prime q < 2^62 = 1 mod 2N are covered."""

    def __init__(self, degree: int, modulus: int, device=None):
        check_arguments(degree, modulus)
        if degree < 2:
            raise ValueError("degree must be at least 2")
        self.device = _device.resolve(device)
        self.plan = get_plan(degree, modulus)
        self.degree = degree
        self.modulus = modulus

    @property
    def root(self) -> int:
        """Minimal primitive 2N-th root of unity used by this engine."""
        return self.plan.root

    def _dispatch(self, x, forward: bool, imf: int, omf: int):
        _check.check_bounds(
            x, imf * self.modulus,
            f"{'forward' if forward else 'inverse'} NTT input")
        fn = cuda_ntt.fwd_ntt if forward else cuda_ntt.inv_ntt
        (tx,), host = _device.operands((x,), self.device)
        if self.plan.single_word:
            out = fn(tx, self.plan, imf, omf, 32)
        else:
            out = fn(tx, self.plan, imf, omf, 64,
                     torch_ntt.scheme_for(self.modulus, self.degree,
                                          tx.device))
        return to_numpy(out) if host else out

    def forward(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        """Forward NTT; input < IMF*q (IMF in {1,2,4}), bit-reversed output
        in [0, q) for OMF=1 or [0, 4q) for OMF=4."""
        return self._dispatch(x, True, input_mod_factor, output_mod_factor)

    def inverse(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        """Inverse NTT; bit-reversed input < IMF*q (IMF in {1,2}), output
        in [0, q) for OMF=1 or [0, 2q) for OMF=2."""
        return self._dispatch(x, False, input_mod_factor, output_mod_factor)

    def root_of_unity_powers(self) -> np.ndarray:
        return self.plan.rop

    def inv_root_of_unity_powers(self) -> np.ndarray:
        return self.plan.irop
