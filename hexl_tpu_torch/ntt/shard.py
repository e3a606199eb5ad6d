"""The passes of one position of the coefficient-sharded NTT (`DistNTT`).

A transform of degree N over a coefficient axis of D positions gives
position r the contiguous shard r of L = N/D coefficients (D^2 divides N,
so L is a multiple of D). The forward runs the cross pass and then the
local pass, the inverse the local pass and then the cross pass
(`hexl_tpu/parallel/dist_ntt.py`):

* the local pass of position r is the flat walk restricted to shard r:
  the stages of stride < L, with the shard's twiddles at its offset in the
  flat tables (block k of the forward stage of m blocks per shard at
  rop[m (D + r) + k], the inverse's at irop[root_index(N, t) + r m + k]).
  The forward ends with the OMF reduction; the inverse stops before the
  global final stage. This is what the JAX package's per-device stage
  tables (`build_stage_lists(base_offset=r L)`) hold.
* the cross pass runs the stages of stride >= L, which pair equal offsets
  of two shards. After the exchange, position c holds a (..., D, lc) block
  (lc = L/D): row r is chunk c of shard r. That is the block the two-pass
  split's cross pass takes (`hier.cross`, K5 with a column stride of lc),
  with the rows at stride L in place of 2^14.

The local pass's plain versions are the walk restricted to the shard
(`torch_ntt` with a shard index). On the GPU it is K6 with a shard base
(`csrc/ntt_hier.cu`); a position of L > 2^14 coefficients first runs
(forward) or last runs (inverse) its stages of stride >= 2^14 through K5
on 2^14-coefficient rows, with the shard's twiddles gathered into a small
table, and the rest through K6 on 2^14 sub-shards. Where K6's grid of one
CTA a shard (or sub-shard) of 2^12 .. 2^14 is under a wave and
`rns.cluster_for` picks C > 1 for it (the rule and table of the one-prime
transforms), the shard runs on a cluster of C CTAs instead (K6.shard.cl,
`csrc/ntt_cluster.cuh` with K6's shard base and period, through the
one-row plan of the prime): a DistNTT position holds one shard of each
polynomial, so the RNS product's positions launch one or two CTAs of K6
on a card of 132 SMs. Its plain version, `local_cluster_plain`, is the
walk cut where the kernels cut it (the CPU takes it where the rule is
forced to C > 1). Launches are counted under "K5", "K6" and
"K6.shard.cl". The layer is 64-bit for every q, as the JAX package's is.

`scheme` picks the local pass's butterflies: "exact" (the JAX package's
XLA bodies) or "approx", the approximate quotient that the TPU kernel
`DistNTT._pallas_local` runs for q < 2^61 (`torch_ntt`; launches "K6.approx"
and, above 2^14, "K5.approx"). The cluster form is exact only, so a
non-exact scheme keeps one CTA a chunk, as `rns._clusters` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build, nt
from ..limb import reduce_mod_lazy64, to_tensor
from . import hier, rns, torch_ntt
from .plan import register_clear_hook

CLUSTER_NAME = "K6.shard.cl"


# -- plain versions ----------------------------------------------------------

def local_fwd_plain(x: torch.Tensor, plan, shard: int, shards: int,
                    omf: int, scheme: str = "exact") -> torch.Tensor:
    """Shard `shard` of `shards` (x (..., L)): the forward stages of stride
    < L, then the OMF reduction (`scheme` one of `torch_ntt.HARVEY`)."""
    x = torch_ntt.fwd_stages(x, plan, 1, x.shape[-1], 64, shard, shards,
                             scheme)
    if omf == 1:
        x = reduce_mod_lazy64(x, plan.q, 4)
    return x


def local_inv_plain(x: torch.Tensor, plan, shard: int, shards: int,
                    scheme: str = "exact") -> torch.Tensor:
    """Shard `shard` of `shards` (x (..., L)): the inverse stages of stride
    < L, without the global final stage."""
    return torch_ntt.inv_stages(x, plan, 1, x.shape[-1], 64, shard, shards,
                                scheme)


def local_cluster_plain(x: torch.Tensor, plan, shard: int, shards: int,
                        forward: bool, omf: int,
                        clusters: int) -> torch.Tensor:
    """The local pass of shard `shard` of `shards` (x (..., L)) cut where
    the cluster form cuts it, C = `clusters` CTAs a chunk of l = min(L,
    2^14): the forward runs the stages of stride >= 2^14 (K5, L > 2^14),
    the cluster's cross stages (strides l/2 .. l/C, on its columns), each
    CTA's stages (stride < l/C) and the OMF reduction; the inverse the
    CTA's stages, the cross stages, then those of stride >= 2^14, and
    stops before the global final stage (ignoring omf)."""
    if clusters not in rns.CLUSTER_SIZES:
        raise ValueError(f"a cluster holds {rns.CLUSTER_SIZES} CTAs, got "
                         f"{clusters}")
    length = x.shape[-1]
    rows = max(1, length // hier.LOCAL_N)
    if length // rows < rns.CLUSTER_DEGREES[0]:
        raise ValueError(f"the cluster form takes shards of at least "
                         f"{rns.CLUSTER_DEGREES[0]}, got {length}")
    args = (64, shard, shards)
    if forward:
        for lo, hi in ((1, rows), (rows, rows * clusters),
                       (rows * clusters, length)):
            x = torch_ntt.fwd_stages(x, plan, lo, hi, *args)
        if omf == 1:
            x = reduce_mod_lazy64(x, plan.q, 4)
        return x
    chunk = length // rows // clusters
    for lo, hi in ((1, chunk), (chunk, length // rows),
                   (length // rows, length)):
        x = torch_ntt.inv_stages(x, plan, lo, hi, *args)
    return x


# -- the kernel wrappers -----------------------------------------------------

def cluster_count(x: torch.Tensor, log_n: int, chunks: int,
                  scheme: str = "exact") -> int:
    """C for the local pass's launch on `chunks` chunks of 2^log_n:
    `rns.cluster_for`'s pick for K6's grid of one CTA a chunk (1 below
    2^12, at a wave or more, off CUDA and in a non-exact scheme, unless
    the rule is forced)."""
    if not chunks:
        return 1
    return rns._clusters(x, 1 << log_n, chunks, scheme)


def local_chunks(x: torch.Tensor, plan, forward: bool, omf: int, log_n: int,
                 log_d: int, shard_base: int, log_sub: int,
                 scheme: str = "exact") -> torch.Tensor:
    """The local pass on the 2^log_n-coefficient chunks of x, a CUDA
    tensor, chunk c shard shard_base + (c mod 2^log_sub) of a transform of
    2^(log_n + log_d) (`hier.local_launch`'s arguments): K6.shard.cl, a
    cluster of C CTAs a chunk, where `cluster_count` gives C > 1, else K6
    in `scheme`. The inverse ignores omf."""
    chunks = _build.batch_of(x, 1 << log_n)
    clusters = cluster_count(x, log_n, chunks, scheme)
    if clusters == 1:
        return hier.local_launch(x, plan, forward, omf, log_n, log_d,
                                 shard_base, log_sub, 64, scheme)
    rows = rns.get_rns_plan(plan.n, (plan.q,)).descriptors(x.device)
    return rns.cluster_chunks(x, rows, CLUSTER_NAME, forward, omf, log_n,
                              log_d, shard_base, log_sub, chunks, clusters)


@functools.lru_cache(maxsize=None)
def intra_twiddles(plan, shard: int, shards: int, forward: bool,
                   device: torch.device):
    """The twiddles of shard `shard`'s stages of stride >= 2^14 (its
    length L = N/shards > 2^14), in K5's layout for R = L/2^14 rows: the
    forward stage of m blocks at [m, 2m), the inverse one at [R - 2m,
    R - m)."""
    rows = plan.n // shards // hier.LOCAL_N
    w = np.zeros(rows, dtype=np.uint64)
    wp = np.zeros(rows, dtype=np.uint64)
    m = 1
    while m < rows:
        # The stage of m blocks over the rows has stride L/(2m): block k
        # is the shard's block k of that global stage.
        if forward:
            at = m
            src = torch_ntt.fwd_index(m, shard, shards)
            w[at:at + m], wp[at:at + m] = (plan.rop[src:src + m],
                                           plan.prop[src:src + m])
        else:
            at = rows - 2 * m
            src = torch_ntt.inv_index(plan.n, m, shard, shards)
            w[at:at + m], wp[at:at + m] = (plan.irop[src:src + m],
                                           plan.pirop[src:src + m])
        m *= 2
    return to_tensor(w, device), to_tensor(wp, device)


register_clear_hook(intra_twiddles.cache_clear)


def local(x: torch.Tensor, plan, shard: int, shards: int, forward: bool,
          omf: int = 1, scheme: str = "exact") -> torch.Tensor:
    """The local pass of shard `shard` of `shards` (x (..., L)): K6 with a
    shard base, or K6.shard.cl where `cluster_count` picks C > 1, on the
    GPU (and K5 for the stages of stride >= 2^14 when L > 2^14); on the
    CPU the plain version (`local_cluster_plain` where the rule is forced
    to C > 1). `scheme` is "exact" or "approx". The inverse ignores
    omf."""
    torch_ntt.check_harvey(scheme, plan.q, "the local pass")
    card = _build.on_card(x)
    length = x.shape[-1]
    log_d = nt.log2_exact(shards)
    rows = max(1, length // hier.LOCAL_N)
    log_rows = nt.log2_exact(rows)
    log_n = nt.log2_exact(length // rows)
    if not card:
        clusters = cluster_count(x, log_n, _build.batch_of(x, length) * rows,
                                 scheme)
        if clusters > 1:
            return local_cluster_plain(x, plan, shard, shards, forward, omf,
                                       clusters)
        if forward:
            return local_fwd_plain(x, plan, shard, shards, omf, scheme)
        return local_inv_plain(x, plan, shard, shards, scheme)
    if rows == 1:
        return local_chunks(x, plan, forward, omf, log_n, log_d, shard, 0,
                            scheme)
    w, wp = intra_twiddles(plan, shard, shards, forward, x.device)

    def intra(v):
        return hier.cross_launch(v, w, wp, plan, log_rows, hier.LOG_LOCAL,
                                 forward, final_stage=False, scheme=scheme)

    def sub_shards(v):
        return local_chunks(v, plan, forward, omf, hier.LOG_LOCAL,
                            log_d + log_rows, shard * rows, log_rows, scheme)

    if forward:
        return sub_shards(intra(x))
    return intra(sub_shards(x))
