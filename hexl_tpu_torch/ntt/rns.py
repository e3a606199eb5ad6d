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

Where a launch's one-CTA grid is under a wave, a transform (K1.rns, N =
2^12 .. 2^14) or 2^14 shard (K6.rns) runs on a cluster of C CTAs joined
through distributed shared memory instead ("K1.rns.cl", "K6.rns.cl";
`csrc/ntt_rns.cu`): C x the SMs for the same work. `cluster_for` picks C
from the card's table (exact scheme only); C = 1 is the one-CTA form. The
one-prime transforms of `cuda_ntt` and `hier` take the same route through
a one-row plan (`cluster_transform`).

A tensor on the GPU goes to the kernels, a tensor on the CPU to the plain
stacked walk (`fwd_ntt_rns_plain`, `inv_ntt_rns_plain`: each row's flat
walk, from the row's descriptor values); there is no other path. Launches
are counted in `_build.launches` under "K1.rns", "K2.rns", "K5.rns",
"K5.tile.rns", "K6.rns", "K1.rns.cl" and "K6.rns.cl" (the lean ones under
"K1.rns.lean16" ...).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build, _device, nt
from ..limb import reduce_mod_lazy64, to_numpy, to_tensor
from ..utils import check as _check
from ..utils import profiling
from . import cuda_ntt, hier, torch_ntt
from .plan import building, cache_stats, get_plan, register_clear_hook

# A row descriptor's 64-bit words, in csrc/rns.cuh RnsRow's order.
ROW_FIELDS = ("q", "inv_n", "inv_n_precon", "inv_n_w", "inv_n_w_precon",
              "rop", "prop", "irop", "pirop")
ROW_WORDS = len(ROW_FIELDS)
TABLES = ("rop", "prop", "irop", "pirop")
# The schemes of the stacked kernels: those of the JAX stacked bodies
# (`jnp_ntt._bflys3`); "approx", the Pallas kernels' form, has no stacked
# instantiation.
STACKED_SCHEMES = ("exact", "lean16", "lean8")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_WHOLE_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_LOCAL_FWD_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_LOCAL_INV_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_CROSS_FWD_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P)
_CROSS_INV_ARGS = (_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P)
_CLUSTER_ARGS = (_P, _P, _P) + (_I,) * 8 + (_P,)


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
                    with building():
                        for plan in self.plans:
                            tabs = plan.tables(device)
                            words.append([plan.q, *plan.fin(64)]
                                         + [tabs[t].data_ptr()
                                            for t in TABLES])
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
                with building():
                    rplan = RnsPlan(degree, key[1])
                _RNS_PLANS[key] = rplan
    elif profiling.records is not None:
        cache_stats["hits"] += 1
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


def fwd_ntt_rns_cluster_plain(x: torch.Tensor, rplan: RnsPlan,
                              clusters: int, input_mod_factor: int = 1,
                              output_mod_factor: int = 1) -> torch.Tensor:
    """The plain version of the cluster form's forward: each row's flat
    exact walk (`torch_ntt.fwd_stages`) cut where the kernels cut it. Above
    2^14 the stages of stride >= 2^14 first (K5.rns); then the cluster's
    cross stages, those of stride >= 2^l / C of a transform or shard of
    2^l (l = min(log N, 14)), which its CTAs run on their columns; then
    the stages within each CTA's chunk of 2^l / C, and the OMF
    reduction."""
    _check_block(x, rplan, True, input_mod_factor, output_mod_factor,
                 "exact")
    return _cluster_plain(x, rplan, clusters, True, output_mod_factor, True)


def inv_ntt_rns_cluster_plain(x: torch.Tensor, rplan: RnsPlan,
                              clusters: int, input_mod_factor: int = 1,
                              output_mod_factor: int = 1) -> torch.Tensor:
    """The plain version of the cluster form's inverse: the stages within
    each CTA's chunk (stride < 2^l / C), then the cluster's cross stages
    (to stride 2^13 of a shard, or to the whole transform's last stage,
    fused with N^-1 and the OMF), then above 2^14 the stages of stride >=
    2^14 (K5.rns, ending with the final stage)."""
    _check_block(x, rplan, False, input_mod_factor, output_mod_factor,
                 "exact")
    return _cluster_plain(x, rplan, clusters, False, output_mod_factor, True)


def _cluster_plain(x, rplan, clusters, forward, omf, whole):
    """Each row's walk cut as the cluster form cuts it: the whole
    transform, or (not whole, N > 2^14) the split's local pass only, the
    inverse then stopping before the cross pass."""
    shards, chunk = _cluster_cut(rplan, clusters)
    n = rplan.n
    out = []
    for i, row in enumerate(_row_plans(rplan, x.device)):
        v = x[i]
        if forward:
            if whole:
                v = torch_ntt.fwd_stages(v, row, 1, shards)
            v = torch_ntt.fwd_stages(v, row, shards, shards * clusters)
            v = torch_ntt.fwd_stages(v, row, shards * clusters, n)
            if omf == 1:
                v = reduce_mod_lazy64(v, row.q, 4)
        else:
            v = torch_ntt.inv_stages(v, row, 1, chunk)
            v = torch_ntt.inv_stages(v, row, chunk, min(n // shards, n // 2))
            if whole:
                v = torch_ntt.inv_stages(v, row, n // shards, n // 2)
                v = torch_ntt.inv_final(v, row, omf)
        out.append(v)
    return torch.stack(out)


def _cluster_cut(rplan: RnsPlan, clusters: int) -> tuple:
    """(D, chunk): the split's shards of 2^14 (1 up to 2^14) and the
    chunk of a transform or shard that each CTA of a cluster of
    `clusters` holds."""
    if clusters not in (1,) + CLUSTER_SIZES:
        raise ValueError(f"a cluster holds 1 or {CLUSTER_SIZES} CTAs, got "
                         f"{clusters}")
    if rplan.n < CLUSTER_DEGREES[0]:
        raise ValueError(f"the cluster form takes N >= "
                         f"{CLUSTER_DEGREES[0]}, got {rplan.n}")
    shards = max(1, rplan.n >> hier.LOG_LOCAL)
    return shards, rplan.n // shards // clusters


# -- the cluster form's rule -------------------------------------------------

# C, the CTAs of a cluster: 2 to 8 portable, 16 with the kernel's
# non-portable attribute (csrc/ntt_rns.cu).
CLUSTER_SIZES = (2, 4, 8, 16)
# The transforms the cluster form takes whole (K1.rns.cl); above, a 2^14
# shard (K6.rns.cl).
CLUSTER_DEGREES = (1 << 12, 1 << 14)
# The card's table (`cluster_for`): {log2 of the transform or shard:
# ((most one-CTA CTAs, C), ...)}, by ascending CTAs; a grid beyond the
# last entry keeps C = 1.
CLUSTER_TABLE: Dict[int, Tuple[Tuple[int, int], ...]] = {
    12: ((28, 4), (32, 8), (64, 2)),
    13: ((48, 8), (64, 2), (96, 8)),
    14: ((6, 16), (12, 8), (56, 16), (64, 2)),
}


@functools.lru_cache(maxsize=None)
def max_active_clusters(log_n: int, clusters: int, device) -> int:
    """How many clusters of `clusters` CTAs of the cluster form at 2^log_n
    (a transform, or a shard) the card holds at once
    (cudaOccupancyMaxActiveClusters; asked once per device)."""
    if clusters not in CLUSTER_SIZES or not (
            CLUSTER_DEGREES[0] <= 1 << log_n <= CLUSTER_DEGREES[1]):
        raise ValueError(f"the cluster form takes C in {CLUSTER_SIZES} and "
                         f"N from 2^12 to 2^14, got C={clusters}, "
                         f"N=2^{log_n}")
    count = ctypes.c_int(0)
    fn = _build.function("ntt_rns", "hexl_rns_cluster_max_active",
                         (_I, _I, ctypes.POINTER(ctypes.c_int)))
    with torch.cuda.device(device):
        err = fn(log_n, clusters.bit_length() - 1, ctypes.byref(count))
    if err:
        raise RuntimeError(f"hexl_tpu_torch: the cluster occupancy query "
                           f"failed with cudaError {err}")
    return count.value


def cluster_for(log_n: int, ctas: int, sms: int, device) -> int:
    """C, the CTAs of a cluster for a launch whose one-CTA form has `ctas`
    CTAs of 2^log_n (a transform of N = 2^log_n, a 2^14 shard of the
    split, or a DistNTT position's shard or sub-shard of 2^12 .. 2^14,
    `shard.local_chunks`) on a card of `sms` SMs; 1 is the one-CTA
    form. The card's table, C by
    one-CTA grid (CLUSTER_TABLE; see below), then the occupancy argument:
    C only where the card holds all `ctas` clusters of C at once
    (`max_active_clusters`), else the next smaller C that it does. C = 1
    at a wave or more (ctas >= sms), off the table, and on a device that
    is not CUDA. A query that finds no cluster of the table's C resident
    raises.

    The table is `chip_smoke.py --cluster-times` (one NVIDIA H100 80GB
    HBM3 at 700.00 W): the forward + inverse pair of one
    50-bit prime at `ctas` one-CTA CTAs, device ms, median of 20 graph
    replays, as "CTAs: C, its ms / C = 1's ms / the split variant's ms"
    (the split: K5 for the stages of stride >= 2^11, then K6 at L = 2^11,
    two launches of kernels the port has; at 2^15 the pair is two shards
    a transform, K5 and the local pass):

    - 2^12: 1: 4, 0.0123/0.0170/0.0134; 4: 4, 0.0126/0.0175/0.0135; 12:
      4, 0.0128/0.0176/0.0135; 28: 4, 0.0133/0.0175/0.0144; 32: 8,
      0.0146/0.0177/0.0144; 48: 2, 0.0152/0.0175/0.0151; 64: 2,
      0.0153/0.0180/0.0159; 96: 1, 0.0186; 128: 1, 0.0196.
    - 2^13: 1: 8, 0.0130/0.0334/0.0135; 4: 8, 0.0133/0.0329/0.0138; 12:
      8, 0.0140/0.0332/0.0146; 28: 8, 0.0163/0.0333/0.0160; 48: 8,
      0.0219/0.0334/0.0220; 56: 2, 0.0224/0.0335/0.0226; 64: 2,
      0.0230/0.0340/0.0232; 96: 8, 0.0316/0.0356/0.0304; 128: 1, 0.0365.
    - 2^14: 1: 16, 0.0149/0.0622/0.0142; 3: 16, 0.0152/0.0621/0.0147; 6:
      16, 0.0154/0.0624/0.0148; 8: 8, 0.0160/0.0618/0.0152; 12: 8,
      0.0168/0.0620/0.0164; 16: 16, 0.0200/0.0624/0.0173; 28: 16,
      0.0231/0.0623/0.0240; 56: 16, 0.0373/0.0630/0.0378; 64: 2,
      0.0423/0.0629/0.0389; 96: 1, 0.0660; 128: 1, 0.0702.
    - 2^15 (the shards, the same C as 2^14 at the same CTAs): 2: 16,
      0.0180/0.0642/0.0161; 6: 16, 0.0185/0.0646/0.0170; 12: 8,
      0.0213/0.0648/0.0177; 24: 16, 0.0281/0.0663/0.0247; 32: 16,
      0.0323/0.0673/0.0261; 56: 16, 0.0466/0.0714/0.0411; 64: 2,
      0.0521/0.0732/0.0422.

    The cluster is 1.2-1.4x faster than one CTA at 2^12, 1.5-2.6x at
    2^13, 2.7-4.2x at 2^14 and 1.4-3.6x at 2^15, up to the grid where
    its clusters no longer fit at once; C = 1 from 96 CTAs (2^12, 2^14)
    or 128 (2^13). Against the one-prime split it is 0.92-0.99x at 2^12
    up to 28 CTAs and 0.95-0.99x at 2^13 up to 16, but 1.02-1.16x at
    2^14 below 20 CTAs and 1.1-1.3x at 2^15: the split's second launch
    costs what the cluster's barrier, its distributed shared memory and
    its column phase cost. A stacked call over k primes has no such split
    (no stacked K6 below 2^14: K5.rns then a K6 launch a prime), and
    there the cluster is 2.2-4.5x faster than that split at every key
    switch launch (PERF.md, section 6).

    At a DistNTT position's grids (`chip_smoke.py --shard-times`, the
    same card and limit; one direction of the local pass, ms, as "C: its
    ms"), the card agrees with the table: a 2^14 shard at 1 CTA and two
    2^14 sub-shards at 2: 16: 0.0069-0.0072, 8: 0.0080-0.0082, 4:
    0.0109-0.0110, 1: 0.0298-0.0303; 2^12 shards at 1-3 CTAs (the key
    switch): 4: 0.0058-0.0064, 8 and 16: 0.0064-0.0066, 2: 0.0072-0.0077,
    1: 0.0082-0.0085; 2^12 at 128 CTAs (DistNTT at batch 256 on a (2, 4)
    mesh): 1: 0.0090-0.0098, 2: 0.0107-0.0111, 4: 0.0114-0.0121."""
    if ctas >= sms or torch.device(device).type != "cuda":
        return 1
    pick = next((c for most, c in CLUSTER_TABLE.get(log_n, ())
                 if ctas <= most), 1)
    while pick > 1:
        active = max_active_clusters(log_n, pick, device)
        if active == 0:
            raise RuntimeError(f"hexl_tpu_torch: no cluster of {pick} CTAs "
                               f"at N=2^{log_n} is resident on {device}")
        if ctas <= active:
            return pick
        pick //= 2
    return 1


# -- the launches ----------------------------------------------------------

def _check_block(x: torch.Tensor, rplan: RnsPlan, forward: bool, imf: int,
                 omf: int, scheme: str) -> None:
    torch_ntt.check_factors(forward, imf, omf)
    torch_ntt.check_scheme(scheme, max(rplan.moduli), 64)
    if scheme not in STACKED_SCHEMES:
        raise ValueError(f"the stacked transform runs {STACKED_SCHEMES} "
                         f"(the JAX stacked bodies' _bflys3), got {scheme!r}")
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


def cluster_chunks(x, rows, name, forward, omf, log_n, log_d, shard_base,
                   log_sub, chunks, clusters):
    """The cluster form on the `chunks` chunks of 2^log_n of each row of x
    (rows: the descriptors), a cluster of `clusters` CTAs a chunk, counted
    under `name`: chunk t is shard shard_base + (t mod 2^log_sub) of the
    2^log_d of a transform of 2^(log_n + log_d) (log_d = 0: whole
    transforms; the inverse of a shard stops before the global final
    stage and ignores omf)."""
    entry = "hexl_rns_cluster_fwd" if forward else "hexl_rns_cluster_inv"
    return _launch("ntt_rns", entry, _CLUSTER_ARGS, name, x, rows, log_n,
                   log_d, shard_base, log_sub, chunks,
                   clusters.bit_length() - 1, omf)


def _cluster(x, rows, rplan, batch, forward, omf, clusters):
    """K1.rns.cl (N <= 2^14: the whole transform) or K6.rns.cl (above:
    the local pass of the split, every 2^14 shard of each transform), a
    cluster of `clusters` CTAs a transform or shard."""
    log_n = min(rplan.log_n, hier.LOG_LOCAL)
    log_d = rplan.log_n - log_n
    return cluster_chunks(x, rows, "K6.rns.cl" if log_d else "K1.rns.cl",
                          forward, omf, log_n, log_d, 0, log_d,
                          batch << log_d, clusters)


def _clusters(x, n, ctas, scheme):
    """`cluster_for`'s C for a launch of `ctas` one-CTA CTAs of degree n in
    the exact scheme, else 1."""
    if scheme != "exact" or n < CLUSTER_DEGREES[0]:
        return 1
    cuda = x.device.type == "cuda"
    return cluster_for(min(nt.log2_exact(n), hier.LOG_LOCAL), ctas,
                       cuda_ntt.sm_count(x.device) if cuda else 0, x.device)


def cluster_transform(x: torch.Tensor, plan, forward: bool, omf: int,
                      batch: int):
    """The route of a 64-bit exact one-prime call (`cuda_ntt` up to 2^14,
    `hier`'s local pass above) to the cluster form, through the one-row
    plan of plan's prime, where `cluster_for` picks C > 1 for its one-CTA
    grid: the output, or None (the caller's own kernel or plain version).
    x (..., N) holds `batch` transforms; above 2^14 the call is the
    split's local pass (the inverse stops before the cross pass). On the
    CPU the cluster form's plain version."""
    ctas = batch << max(0, plan.log_n - hier.LOG_LOCAL)
    clusters = _clusters(x, plan.n, ctas, "exact") if batch else 1
    if clusters == 1:
        return None
    rplan = get_rns_plan(plan.n, (plan.q,))
    if not _build.on_card(x):
        return _cluster_plain(x.reshape(1, *x.shape), rplan, clusters,
                              forward, omf, plan.n <= hier.LOCAL_N)[0]
    # The kernels read x as the one row's batch transforms: no row axis.
    return _cluster(x, rplan.descriptors(x.device), rplan, batch, forward,
                    omf, clusters)


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
    card = _build.on_card(x)
    batch = _build.batch_of(x, rplan.n) // rplan.k
    clusters = 1
    if batch and cuda_ntt.polys_per_cta(rplan.n, batch) == 1:
        clusters = _clusters(x, rplan.n, rplan.k * batch << max(
            0, rplan.log_n - hier.LOG_LOCAL), scheme)
    if not card:
        if clusters > 1:
            return _cluster_plain(x, rplan, clusters, forward, omf, True)
        fn = fwd_ntt_rns_plain if forward else inv_ntt_rns_plain
        return fn(x, rplan, imf, omf, scheme)
    if batch == 0:
        return torch.empty_like(x)
    rows = rplan.descriptors(x.device)

    def local(v):
        """The whole transform up to 2^14, the local pass above."""
        if clusters > 1:
            return _cluster(v, rows, rplan, batch, forward, omf, clusters)
        if rplan.n <= cuda_ntt.MAX_KERNEL_DEGREE:
            return _whole(v, rows, rplan, batch, forward, omf, scheme)
        return _local(v, rows, rplan, batch, forward, omf, scheme)
    if rplan.n <= cuda_ntt.MAX_KERNEL_DEGREE:
        return local(x)
    if forward:
        return local(_cross(x, rows, rplan, batch, True, omf, scheme))
    return _cross(local(x), rows, rplan, batch, False, omf, scheme)


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

    def _operand(self, x, forward: bool, imf: int):
        """(x as a tensor, host): the input's checks."""
        (tx,), host = _device.operands((x,), self.device)
        if tx.dim() < 2 or tx.shape[0] != self.plan.k:
            raise ValueError(
                f"input leading axis must be the {self.plan.k}-prime basis "
                f"axis, got shape {tuple(tx.shape)}")
        _check.check_row_bounds(
            tx, [imf * q for q in self.moduli],
            f"{'forward' if forward else 'inverse'} RNS NTT input")
        return tx, host

    def _route(self, tx, forward: bool, imf: int, omf: int):
        return _stacked(tx, self.plan, imf, omf, forward,
                        torch_ntt.scheme_for(max(self.moduli), self.degree,
                                             tx.device))

    def _dispatch(self, x, forward: bool, imf: int, omf: int):
        if not profiling.on():
            tx, host = self._operand(x, forward, imf)
            out = self._route(tx, forward, imf, omf)
            return to_numpy(out) if host else out
        name = "hexl.rns_ntt.forward" if forward else "hexl.rns_ntt.inverse"
        with profiling.Span(name):
            with profiling.Span(profiling.CHECKS):
                tx, host = self._operand(x, forward, imf)
            with profiling.Span("hexl.rns_ntt.route"):
                out = self._route(tx, forward, imf, omf)
            return to_numpy(out) if host else out

    def forward(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        return self._dispatch(x, True, input_mod_factor, output_mod_factor)

    def inverse(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1):
        return self._dispatch(x, False, input_mod_factor, output_mod_factor)
