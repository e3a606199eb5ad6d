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
table, and the rest through K6 on 2^14 sub-shards. Launches are counted
under "K5" and "K6". The layer is 64-bit for every q, as the JAX
package's is.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build, nt
from ..limb import reduce_mod_lazy64, to_tensor
from . import hier, torch_ntt


# -- plain versions ----------------------------------------------------------

def local_fwd_plain(x: torch.Tensor, plan, shard: int, shards: int,
                    omf: int) -> torch.Tensor:
    """Shard `shard` of `shards` (x (..., L)): the forward stages of stride
    < L, then the OMF reduction."""
    x = torch_ntt.fwd_stages(x, plan, 1, x.shape[-1], 64, shard, shards)
    if omf == 1:
        x = reduce_mod_lazy64(x, plan.q, 4)
    return x


def local_inv_plain(x: torch.Tensor, plan, shard: int,
                    shards: int) -> torch.Tensor:
    """Shard `shard` of `shards` (x (..., L)): the inverse stages of stride
    < L, without the global final stage."""
    return torch_ntt.inv_stages(x, plan, 1, x.shape[-1], 64, shard, shards)


# -- the kernel wrappers -----------------------------------------------------

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


def local(x: torch.Tensor, plan, shard: int, shards: int, forward: bool,
          omf: int = 1) -> torch.Tensor:
    """The local pass of shard `shard` of `shards` (x (..., L)): K6 with a
    shard base on the GPU (and K5 for the stages of stride >= 2^14 when
    L > 2^14), the plain version on the CPU. The inverse ignores omf."""
    if not _build.on_card(x):
        if forward:
            return local_fwd_plain(x, plan, shard, shards, omf)
        return local_inv_plain(x, plan, shard, shards)
    length = x.shape[-1]
    log_d = nt.log2_exact(shards)
    if length <= hier.LOCAL_N:
        return hier.local_launch(x, plan, forward, omf,
                                 nt.log2_exact(length), log_d, shard, 0)
    rows = length // hier.LOCAL_N
    log_rows = nt.log2_exact(rows)
    w, wp = intra_twiddles(plan, shard, shards, forward, x.device)

    def intra(v):
        return hier.cross_launch(v, w, wp, plan, log_rows, hier.LOG_LOCAL,
                                 forward, final_stage=False)

    def sub_shards(v):
        return hier.local_launch(v, plan, forward, omf, hier.LOG_LOCAL,
                                 log_d + log_rows, shard * rows, log_rows)

    if forward:
        return sub_shards(intra(x))
    return intra(sub_shards(x))
