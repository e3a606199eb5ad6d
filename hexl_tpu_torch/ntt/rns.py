"""Stacked multi-modulus (RNS) NTT: one launch a pass over a prime basis.

The counterpart of `hexl_tpu/ntt/rns.py` (`RnsNttPlan`, `fwd_ntt_rns`,
`inv_ntt_rns`, `RnsNTT`, `get_rns_plan`). The modulus axis is the leading
axis of a (k, ..., N) block, and the per-prime scalars and tables are
operands with that axis: here a (k,) array of row descriptors on the
device (`RnsPlan.descriptors`: each prime's modulus, the constants of its
final inverse stage, and the addresses of its own plan's tables, which
are not copied). One launch transforms the whole block for N <= 2^14
(K1.rns, or K2.rns packing several small transforms of one row a CTA,
`csrc/ntt_rns.cu`), two above (the split of `hier`: K5.rns then K6.rns
forward, K6.rns then K5.rns inverse, `csrc/ntt_rns.cu` and
`csrc/cross_rns.cu`, K5.rns in the form `hier.cross_form` picks for the
stacked batch). A CTA takes its row from its grid position and reads that
row's descriptor; the walk is the single-modulus kernel's.

Row i is transformed under moduli[i], bit for bit as the **64-bit**
single-modulus transform of `cuda_ntt` (K1/K2 up to 2^14, K5/K6 above),
lazy outputs included. The JAX stacked path never takes the single-word
regime (rns.py:13-16): a q < 2^30 prime in a basis runs the 64-bit walk
here too, not `ntt32`, so its lazy outputs are those of the 64-bit walk and
not those of `NTT(N, q)`. Where `config.approx_butterflies(device)` says
so, every row runs the approximate-quotient butterflies of the scheme that
the basis's largest modulus allows (`torch_ntt.scheme_for(max(moduli),
N)`), as the JAX stacked bodies do (rns.py:118-177). Under
HEXL_TPU_DEBUG=1 row i is checked below IMF x moduli[i], as in the JAX
engine.

A tensor on the GPU goes to the kernels, a tensor on the CPU to the plain
stacked walk (`fwd_ntt_rns_plain`, `inv_ntt_rns_plain`: each row's flat
walk, from the row's descriptor values); there is no other path. Launches
are counted in `_build.launches` under "K1.rns", "K2.rns", "K5.rns",
"K5.tile.rns" and "K6.rns" (the lean ones under "K1.rns.lean16" ...).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build, _device, nt
from ..limb import to_numpy, to_tensor
from ..utils import check as _check
from . import cuda_ntt, hier, torch_ntt
from .plan import get_plan, register_clear_hook

# A row descriptor's 64-bit words, in csrc/rns.cuh RnsRow's order.
ROW_FIELDS = ("q", "inv_n", "inv_n_precon", "inv_n_w", "inv_n_w_precon",
              "rop", "prop", "irop", "pirop")
ROW_WORDS = len(ROW_FIELDS)
TABLES = ("rop", "prop", "irop", "pirop")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_WHOLE_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_LOCAL_FWD_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_LOCAL_INV_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_CROSS_FWD_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_CROSS_INV_ARGS = (_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P)


class RnsPlan:
    """The per-prime plans of one degree over k distinct primes, and their
    row descriptors per device."""

    def __init__(self, degree: int, moduli):
        self.n = degree
        self.log_n = nt.log2_exact(degree)
        self.moduli = tuple(int(q) for q in moduli)
        if not self.moduli:
            raise ValueError("the basis needs at least one modulus")
        if len(set(self.moduli)) != len(self.moduli):
            raise ValueError("moduli must be distinct")
        self.k = len(self.moduli)
        self.plans = [get_plan(degree, q) for q in self.moduli]
        self._rows: Dict[str, torch.Tensor] = {}
        self._words: Dict[str, list] = {}
        self._lock = threading.Lock()

    def descriptors(self, device) -> torch.Tensor:
        """(k, ROW_WORDS) int64 on `device`: row i holds moduli[i], its
        plan's final-stage constants (`NttPlan.fin`) and the addresses of
        its plan's tables on `device` (copied there once, by the plan). Built
        once per device; the plans, which this RnsPlan holds, keep the
        tables alive. `row_words(device)` holds the same words on the
        host."""
        key = str(torch.device(device))
        rows = self._rows.get(key)
        if rows is None:
            with self._lock:
                rows = self._rows.get(key)
                if rows is None:
                    words = []
                    for plan in self.plans:
                        tabs = plan.tables(device)
                        words.append([plan.q, *plan.fin(64)]
                                     + [tabs[t].data_ptr() for t in TABLES])
                    rows = to_tensor(np.array(words, dtype=np.uint64),
                                     device)
                    self._words[key] = words
                    self._rows[key] = rows
        return rows

    def row_words(self, device) -> list:
        """The descriptors of `device` as lists of ints, on the host (read
        without a copy from the device, so also inside a CUDA graph's
        capture)."""
        self.descriptors(device)
        return self._words[str(torch.device(device))]


_RNS_PLANS: Dict[Tuple[int, Tuple[int, ...]], RnsPlan] = {}
_RNS_LOCK = threading.Lock()

# clear_plan_cache drops the stacked plans, and their descriptors, with the
# per-prime plans whose tables the descriptors point at.
register_clear_hook(_RNS_PLANS.clear)


def get_rns_plan(degree: int, moduli, device=None) -> RnsPlan:
    """The cached RnsPlan of (N, moduli); its per-prime plans come from the
    `get_plan` cache. With a device, each prime's tables are copied there
    and the row descriptors built, as `get_plan` copies its tables."""
    key = (degree, tuple(int(q) for q in moduli))
    rplan = _RNS_PLANS.get(key)
    if rplan is None:
        with _RNS_LOCK:
            rplan = _RNS_PLANS.get(key)
            if rplan is None:
                rplan = RnsPlan(degree, key[1])
                _RNS_PLANS[key] = rplan
    if device is not None:
        rplan.descriptors(device)
    return rplan


# -- the plain stacked walk ------------------------------------------------

class _RowPlan:
    """Row i's walk parameters as its descriptor gives them: the modulus
    and the final stage's constants from the descriptor, the tables its
    addresses point at (its plan's, checked)."""

    def __init__(self, plan, words: list, device):
        tabs = plan.tables(device)
        if [tabs[t].data_ptr() for t in TABLES] != words[5:]:
            raise RuntimeError("an RNS row descriptor does not point at its "
                               "plan's tables")
        self.n, self.log_n, self._plan = plan.n, plan.log_n, plan
        self.q = words[0]
        self._fin = tuple(words[1:5])

    def fin(self, word: int = 64):
        return self._fin

    def twiddles(self, device, forward: bool, word: int = 64):
        return self._plan.twiddles(device, forward, word)


def _row_plans(rplan: RnsPlan, device) -> list:
    return [_RowPlan(p, words, device)
            for p, words in zip(rplan.plans, rplan.row_words(device))]


def fwd_ntt_rns_plain(x: torch.Tensor, rplan: RnsPlan,
                      input_mod_factor: int = 1, output_mod_factor: int = 1,
                      scheme: str = "exact") -> torch.Tensor:
    """The plain version of `fwd_ntt_rns`: row i's flat 64-bit walk
    (`torch_ntt.fwd_ntt`) under row i's descriptor."""
    _check_block(x, rplan, True, input_mod_factor, output_mod_factor, scheme)
    return torch.stack([
        torch_ntt.fwd_ntt(x[i], row, input_mod_factor, output_mod_factor, 64,
                          scheme)
        for i, row in enumerate(_row_plans(rplan, x.device))])


def inv_ntt_rns_plain(x: torch.Tensor, rplan: RnsPlan,
                      input_mod_factor: int = 1, output_mod_factor: int = 1,
                      scheme: str = "exact") -> torch.Tensor:
    """The plain version of `inv_ntt_rns`."""
    _check_block(x, rplan, False, input_mod_factor, output_mod_factor, scheme)
    return torch.stack([
        torch_ntt.inv_ntt(x[i], row, input_mod_factor, output_mod_factor, 64,
                          scheme)
        for i, row in enumerate(_row_plans(rplan, x.device))])


# -- the launches ----------------------------------------------------------

def _check_block(x: torch.Tensor, rplan: RnsPlan, forward: bool, imf: int,
                 omf: int, scheme: str) -> None:
    torch_ntt.check_factors(forward, imf, omf)
    torch_ntt.check_scheme(scheme, max(rplan.moduli), 64)
    if x.dim() < 2 or x.shape[0] != rplan.k or x.shape[-1] != rplan.n:
        raise ValueError(f"input must have shape ({rplan.k}, ..., "
                         f"{rplan.n}), got {tuple(x.shape)}")


def _launch(lib: str, entry: str, argtypes, name: str, x: torch.Tensor,
            rows: torch.Tensor, *args) -> torch.Tensor:
    """The C entry `entry` of lib{lib}.so on x, rows and args, launched and
    counted under `name`; returns its output."""
    out = torch.empty_like(x)
    fn = _build.function(lib, entry, argtypes)
    _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                     rows.data_ptr(), rows.shape[0], *args)
    return out


def _whole(x, rows, rplan, batch, forward, omf, scheme):
    """K1.rns or K2.rns: the whole transform, N <= 2^14."""
    pp = cuda_ntt.polys_per_cta(rplan.n, batch)
    name = hier.kernel_name("K2.rns" if pp > 1 else "K1.rns", 64, scheme)
    entry = "hexl_ntt_fwd_rns" if forward else "hexl_ntt_inv_rns"
    return _launch("ntt_rns", entry, _WHOLE_ARGS, name, x, rows,
                   rplan.log_n, batch, pp, omf, torch_ntt.SCHEME_CODE[scheme])


def _local(x, rows, rplan, batch, forward, omf, scheme):
    """K6.rns: the local pass of the split."""
    log_d = rplan.log_n - hier.LOG_LOCAL
    name = hier.kernel_name("K6.rns", 64, scheme)
    code = torch_ntt.SCHEME_CODE[scheme]
    if forward:
        return _launch("ntt_rns", "hexl_local_fwd_rns", _LOCAL_FWD_ARGS,
                       name, x, rows, hier.LOG_LOCAL, log_d, batch, omf, code)
    return _launch("ntt_rns", "hexl_local_inv_rns", _LOCAL_INV_ARGS, name,
                   x, rows, hier.LOG_LOCAL, log_d, batch, code)


def _cross(x, rows, rplan, batch, forward, omf, scheme):
    """K5.rns in `hier.cross_form`'s form for the stacked batch: the cross
    pass of the split; the inverse ends with the final stage and the
    OMF."""
    log_d = rplan.log_n - hier.LOG_LOCAL
    aligned = x.data_ptr() % 16 == 0
    form = hier.cross_form(log_d, hier.LOG_LOCAL, rplan.k * batch, 64,
                           scheme, aligned)
    if form not in hier.cross_forms(log_d, hier.LOG_LOCAL, aligned):
        raise ValueError(f"K5's {form} form does not take blocks of "
                         f"({1 << log_d}, {hier.LOCAL_N})")
    name = hier.kernel_name(hier.CROSS_FORMS[form] + ".rns", 64, scheme)
    entry = "hexl_cross_tile" if form == "tile" else "hexl_cross"
    code = torch_ntt.SCHEME_CODE[scheme]
    if forward:
        return _launch("cross_rns", entry + "_fwd_rns", _CROSS_FWD_ARGS,
                       name, x, rows, log_d, hier.LOG_LOCAL, batch, code)
    skip = torch_ntt.root_index(rplan.n, rplan.n >> log_d)
    return _launch("cross_rns", entry + "_inv_rns", _CROSS_INV_ARGS, name,
                   x, rows, log_d, hier.LOG_LOCAL, batch, skip, omf, code)


def _stacked(x: torch.Tensor, rplan: RnsPlan, imf: int, omf: int,
             forward: bool, scheme: str) -> torch.Tensor:
    _check_block(x, rplan, forward, imf, omf, scheme)
    if not _build.on_card(x):
        fn = fwd_ntt_rns_plain if forward else inv_ntt_rns_plain
        return fn(x, rplan, imf, omf, scheme)
    batch = _build.batch_of(x, rplan.n) // rplan.k
    if batch == 0:
        return torch.empty_like(x)
    rows = rplan.descriptors(x.device)
    if rplan.n <= cuda_ntt.MAX_KERNEL_DEGREE:
        return _whole(x, rows, rplan, batch, forward, omf, scheme)
    if forward:
        return _local(_cross(x, rows, rplan, batch, True, omf, scheme), rows,
                      rplan, batch, True, omf, scheme)
    return _cross(_local(x, rows, rplan, batch, False, omf, scheme), rows,
                  rplan, batch, False, omf, scheme)


def fwd_ntt_rns(x: torch.Tensor, rplan: RnsPlan, input_mod_factor: int = 1,
                output_mod_factor: int = 1,
                scheme: str = "exact") -> torch.Tensor:
    """Forward NTT of x (k, ..., N), row i under moduli[i], every row
    with the butterflies of `scheme`: one launch (N <= 2^14) or two on a
    CUDA tensor, the plain stacked walk on a CPU tensor."""
    return _stacked(x, rplan, input_mod_factor, output_mod_factor, True,
                    scheme)


def inv_ntt_rns(x: torch.Tensor, rplan: RnsPlan, input_mod_factor: int = 1,
                output_mod_factor: int = 1,
                scheme: str = "exact") -> torch.Tensor:
    """Inverse NTT of x (k, ..., N), row i under moduli[i]."""
    return _stacked(x, rplan, input_mod_factor, output_mod_factor, False,
                    scheme)


class RnsNTT:
    """Forward/inverse negacyclic NTT over an RNS prime basis, stacked.

    rns = RnsNTT(degree, moduli)            # on the GPU
    y = rns.forward(x)    # x: (k, ..., N); row i transformed mod moduli[i]
    x = rns.inverse(y)

    device: where numpy inputs run (default CUDA, which must be present);
    tensor inputs run on their own device. The plan's tables and row
    descriptors are built on `device` at construction."""

    def __init__(self, degree: int, moduli, device=None):
        if degree < 2:
            raise ValueError("degree must be at least 2")
        self.device = _device.resolve(device)
        self.plan = get_rns_plan(degree, moduli, self.device)
        self.degree = degree
        self.moduli = self.plan.moduli

    def _dispatch(self, x, forward: bool, imf: int, omf: int):
        (tx,), host = _device.operands((x,), self.device)
        if tx.dim() < 2 or tx.shape[0] != self.plan.k:
            raise ValueError(
                f"input leading axis must be the {self.plan.k}-prime basis "
                f"axis, got shape {tuple(tx.shape)}")
        _check.check_row_bounds(
            tx, [imf * q for q in self.moduli],
            f"{'forward' if forward else 'inverse'} RNS NTT input")
        out = _stacked(tx, self.plan, imf, omf, forward,
                       torch_ntt.scheme_for(max(self.moduli), self.degree,
                                            tx.device))
        return to_numpy(out) if host else out

    def forward(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        return self._dispatch(x, True, input_mod_factor, output_mod_factor)

    def inverse(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        return self._dispatch(x, False, input_mod_factor, output_mod_factor)
