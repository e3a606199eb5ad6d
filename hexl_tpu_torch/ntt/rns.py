"""Multi-modulus (RNS) NTT: one transform per prime of a basis.

The counterpart of `hexl_tpu/ntt/rns.py` (`RnsNTT`, `get_rns_plan`). Row i
of an input shaped (k, ..., N) is transformed under moduli[i], bit for bit
as the **64-bit** single-modulus transform of `cuda_ntt` (K1/K2 up to
2^14, K5/K6 above), lazy outputs included. The JAX stacked path never
takes the single-word regime (rns.py:13-16): a q < 2^30 prime in a basis
runs the 64-bit walk here too, not `ntt32`, so its lazy outputs are those
of the 64-bit walk and not those of `NTT(N, q)`. Where
`config.approx_butterflies(device)` says so, every row runs the
approximate-quotient butterflies of the scheme that the basis's largest
modulus allows (`torch_ntt.scheme_for(max(moduli), N)`), as the JAX
stacked bodies do (rns.py:118-177). Under HEXL_TPU_DEBUG=1 row i is
checked below IMF x moduli[i], as in the JAX engine.

Each row is one launch per pass (k launches per direction for N <= 2^14,
2k above). A single stacked launch with per-row q and table offsets is
later work (ROADMAP).
"""

from __future__ import annotations

import torch

from .. import _device
from ..limb import to_numpy
from ..utils import check as _check
from . import cuda_ntt, torch_ntt
from .plan import get_plan


class RnsPlan:
    """The per-prime plans of one degree over k distinct primes."""

    def __init__(self, degree: int, moduli):
        self.n = degree
        self.moduli = tuple(int(q) for q in moduli)
        if not self.moduli:
            raise ValueError("the basis needs at least one modulus")
        if len(set(self.moduli)) != len(self.moduli):
            raise ValueError("moduli must be distinct")
        self.k = len(self.moduli)
        self.plans = [get_plan(degree, q) for q in self.moduli]


def get_rns_plan(degree: int, moduli) -> RnsPlan:
    """The RnsPlan of (N, moduli); its per-prime plans come from the
    `get_plan` cache."""
    return RnsPlan(degree, moduli)


def fwd_ntt_rns(x: torch.Tensor, rplan: RnsPlan, input_mod_factor: int = 1,
                output_mod_factor: int = 1,
                scheme: str = "exact") -> torch.Tensor:
    """Forward NTT of x (k, ..., N), row i under moduli[i], every row
    with the butterflies of `scheme`."""
    return torch.stack([
        cuda_ntt.fwd_ntt(x[i], p, input_mod_factor, output_mod_factor, 64,
                         scheme)
        for i, p in enumerate(rplan.plans)])


def inv_ntt_rns(x: torch.Tensor, rplan: RnsPlan, input_mod_factor: int = 1,
                output_mod_factor: int = 1,
                scheme: str = "exact") -> torch.Tensor:
    """Inverse NTT of x (k, ..., N), row i under moduli[i]."""
    return torch.stack([
        cuda_ntt.inv_ntt(x[i], p, input_mod_factor, output_mod_factor, 64,
                         scheme)
        for i, p in enumerate(rplan.plans)])


class RnsNTT:
    """Forward/inverse negacyclic NTT over an RNS prime basis.

    rns = RnsNTT(degree, moduli)            # on the GPU
    y = rns.forward(x)    # x: (k, ..., N); row i transformed mod moduli[i]
    x = rns.inverse(y)

    device: where numpy inputs run (default CUDA, which must be present);
    tensor inputs run on their own device."""

    def __init__(self, degree: int, moduli, device=None):
        if degree < 2:
            raise ValueError("degree must be at least 2")
        self.device = _device.resolve(device)
        self.plan = get_rns_plan(degree, moduli)
        self.degree = degree
        self.moduli = self.plan.moduli

    def _dispatch(self, x, forward: bool, imf: int, omf: int):
        (tx,), host = _device.operands((x,), self.device)
        if tx.dim() < 2 or tx.shape[0] != self.plan.k:
            raise ValueError(
                f"input leading axis must be the {self.plan.k}-prime basis "
                f"axis, got shape {tuple(tx.shape)}")
        for i, q in enumerate(self.moduli):
            _check.check_bounds(
                tx[i], imf * q,
                f"{'forward' if forward else 'inverse'} RNS NTT input "
                f"(prime {i})")
        fn = fwd_ntt_rns if forward else inv_ntt_rns
        out = fn(tx, self.plan, imf, omf,
                 torch_ntt.scheme_for(max(self.moduli), self.degree,
                                      tx.device))
        return to_numpy(out) if host else out

    def forward(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        return self._dispatch(x, True, input_mod_factor, output_mod_factor)

    def inverse(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        return self._dispatch(x, False, input_mod_factor, output_mod_factor)
