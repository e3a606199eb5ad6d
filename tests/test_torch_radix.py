"""The contract of the radix walk's shard launch (K6 with a shard base and
a period), through its plain version `hier.local_launch_plain`, against
JAX.

A transform of N = 2^(log_n + log_d) runs its first log_d forward stages
(the cross stages), then the local pass on its 2^log_d shards. Launched
with a shard base and a period, chunk c of the local pass is shard
base + (c mod 2^log_sub): taking the shards of each polynomial in runs of
2^log_sub at every base and putting the outputs back in place gives the
whole forward, held bit for bit (lazy outputs included) against the JAX
engine on the CPU (its exact body) and the NumPy oracle `hexl_tpu.ref`;
the inverse likewise, its local pass first. The lean schemes and the
single word are held against the split's plain local pass.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu_torch import get_plan
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import hier, torch_ntt

import chip_smoke


def _by_runs(x, plan, forward, omf, log_n, log_d, log_sub, scheme="exact",
             word=64):
    """The local pass of x (batch, N) as launches of 2^log_sub shards of
    each polynomial at bases 0, 2^log_sub, ..., put back in place."""
    d, period, n = 1 << log_d, 1 << log_sub, 1 << log_n
    shards = x.reshape(x.shape[0], d, n)
    out = torch.empty_like(shards)
    for base in range(0, d, period):
        run = shards[:, base:base + period].reshape(-1, n)
        out[:, base:base + period] = hier.local_launch_plain(
            run, plan, forward, omf, log_n, log_d, base, log_sub, word,
            scheme).reshape(x.shape[0], period, n)
    return out.reshape(x.shape)


@pytest.mark.parametrize("log_n,log_d,log_sub", [(1, 2, 1), (3, 2, 1),
                                                 (5, 3, 2), (6, 1, 0),
                                                 (4, 3, 3)])
def test_shard_runs_make_the_jax_transform(log_n, log_d, log_sub):
    n_big = 1 << (log_n + log_d)
    q = jnt.generate_primes(1, 60, True, ntt_size=n_big)[0]
    plan, jp, theirs = get_plan(n_big, q), jax_get_plan(n_big, q), \
        JaxNTT(n_big, q)
    rng = np.random.default_rng(log_n * 16 + log_d)
    x = rng.integers(0, q, size=(2, n_big), dtype=np.uint64)
    xt = to_tensor(x, "cpu")
    cross = torch_ntt.fwd_stages(xt, plan, 1, 1 << log_d)
    lazy = _by_runs(cross, plan, True, 4, log_n, log_d, log_sub)
    np.testing.assert_array_equal(to_numpy(lazy),
                                  np.asarray(theirs.forward(x, 1, 4)))
    np.testing.assert_array_equal(
        to_numpy(lazy), np.stack([ref.fwd_ntt_radix2(v, q, jp.rop, jp.prop,
                                                     1, 4) for v in x]))
    assert torch.equal(_by_runs(cross, plan, True, 1, log_n, log_d, log_sub),
                       lazy % q)
    loc = _by_runs(xt, plan, False, 1, log_n, log_d, log_sub)
    back = torch_ntt.inv_final(
        torch_ntt.inv_stages(loc, plan, 1 << log_n, n_big // 2), plan, 1)
    np.testing.assert_array_equal(to_numpy(back),
                                  np.asarray(theirs.inverse(x, 1, 1)))


@pytest.mark.parametrize("q_bits,word,scheme", [(50, 64, "lean16"),
                                                (60, 64, "lean8"),
                                                (29, 32, "exact")])
def test_shard_runs_in_every_form(q_bits, word, scheme):
    """At N = 2^15 (two shards of 2^14) and N = 2^17 (eight), one launch
    per shard, against the split's plain local pass."""
    rng = np.random.default_rng(q_bits)
    for log_d, log_sub in ((1, 0), (3, 1)):
        n_big = 1 << (14 + log_d)
        q = jnt.generate_primes(1, q_bits, True, ntt_size=n_big)[0]
        plan = get_plan(n_big, q)
        x = to_tensor(rng.integers(0, 4 * q, size=(1, n_big),
                                   dtype=np.uint64), "cpu")
        for omf in (1, 4):
            assert torch.equal(
                _by_runs(x, plan, True, omf, 14, log_d, log_sub, scheme,
                         word),
                hier.local_fwd_plain(x, plan, omf, word, scheme))
        x = x % (2 * q)
        assert torch.equal(
            _by_runs(x, plan, False, 1, 14, log_d, log_sub, scheme, word),
            hier.local_inv_plain(x, plan, word, scheme))


def test_spill_check_counts_every_radix_shape():
    """chip_smoke.py's register check expects one radix instantiation per
    form and shape: the shapes are those `with_shape` dispatches to."""
    src = (pathlib.Path(chip_smoke.ROOT) / "hexl_tpu_torch" / "csrc"
           / "ntt_block.cuh").read_text()
    body = src[src.index("static int with_shape"):]
    body = body[:body.index("\n}\n")]
    shapes = len(re.findall(r"return f\(Index<", body))
    assert shapes == 7
    assert chip_smoke.RADIX_INSTANTIATIONS == (4 + 7) * shapes
    for name in ("_Z16radix_fwd_kernelIyLi0ELi3ELi2ELi14EEvPKyPyS1_S1_yiiiii",
                 "_Z16radix_inv_kernelIjLi0ELi3ELi1ELi0ELb0EEvPKyPyS1_S1_y8"
                 "InvFinalIT_Eiiiii"):
        assert chip_smoke.NEW_INSTANTIATION.search(name)
