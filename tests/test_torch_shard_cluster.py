"""A DistNTT position's local pass on a cluster of CTAs (K6.shard.cl), CPU.

Where K6's grid of one CTA a shard (or 2^14 sub-shard) of 2^12 .. 2^14 is
under a wave, `shard.local` runs the shard on a cluster of C CTAs
(`rns.cluster_for`'s rule and table). Its plain version,
`shard.local_cluster_plain`, is the walk cut where the kernels cut it.
Here: that walk against the uncut plain local pass at L = 2^12 and 2^13
for D = 2 and 4, every position and C; above 2^14 against the NumPy
oracle `hexl_tpu.ref` at one (D, r); the rule forced to C > 1 on the CPU
(every position's local pass then takes the cluster's plain version),
with `DistNTT` and `dist_rns_poly_mult` against `hexl_tpu.parallel`'s on
the same inputs; the rule at the grids a DistNTT position launches; and
the C entries' argument lists. Lazy outputs included, every comparison is
exact equality.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.parallel import DistNTT as JaxDistNTT
from hexl_tpu.parallel import dist_rns_poly_mult as jax_dist_rns_poly_mult
from hexl_tpu.parallel import make_mesh as jax_make_mesh
from hexl_tpu_torch import rns_poly_mult_mod
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import get_plan, rns, shard, torch_ntt
from hexl_tpu_torch.parallel import DistNTT, dist_rns_poly_mult, make_mesh
from tests.torch_threads import one_torch_thread  # noqa: F401

SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "hexl_tpu_torch" / "csrc"


def _plan(log_n, q_bits=60):
    n = 1 << log_n
    return get_plan(n, jnt.generate_primes(1, q_bits, True, ntt_size=n)[0])


def _residues(rng, bound, shape):
    return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                     "cpu")


@pytest.mark.parametrize("log_l", [12, 13])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("clusters", rns.CLUSTER_SIZES)
def test_cluster_plain_vs_local_plain(log_l, d, clusters):
    """Every position r of D, the forward at OMF 1 and 4 and the inverse:
    the cut walk equals the uncut local pass."""
    plan = _plan(log_l + d.bit_length() - 1)
    rng = np.random.default_rng(log_l + 7 * d + clusters)
    for r in range(d):
        x = _residues(rng, 4 * plan.q, (2, 1 << log_l))
        for omf in (1, 4):
            assert torch.equal(
                shard.local_cluster_plain(x, plan, r, d, True, omf, clusters),
                shard.local_fwd_plain(x, plan, r, d, omf)), (r, omf)
        x = _residues(rng, 2 * plan.q, (2, 1 << log_l))
        assert torch.equal(
            shard.local_cluster_plain(x, plan, r, d, False, 1, clusters),
            shard.local_inv_plain(x, plan, r, d)), r


@pytest.mark.parametrize("clusters", [2, 16])
def test_cluster_plain_above_2_14_vs_oracle(clusters):
    """L = 2^15 (N = 2^16, D = 2), position 1: the flat walk's stages of
    stride >= L, then the cut local pass, equal that shard of the oracle's
    forward; the cut inverse pass at position 1 (the plain one at 0), then
    the stages of stride >= L and the final stage, equal its inverse."""
    d, r, log_n = 2, 1, 16
    plan = _plan(log_n, 50)
    n, length = plan.n, plan.n // d
    rng = np.random.default_rng(clusters)
    x = rng.integers(0, plan.q, size=n, dtype=np.uint64)
    cross = torch_ntt.fwd_stages(to_tensor(x, "cpu"), plan, 1, d)
    part = cross[r * length:(r + 1) * length]
    for omf in (1, 4):
        got = shard.local_cluster_plain(part, plan, r, d, True, omf,
                                        clusters)
        want = ref.fwd_ntt_radix2(x, plan.q, plan.rop, plan.prop, 1, omf)
        np.testing.assert_array_equal(to_numpy(got),
                                      want[r * length:(r + 1) * length])
    y = rng.integers(0, 2 * plan.q, size=n, dtype=np.uint64)
    yt = to_tensor(y, "cpu")
    parts = [shard.local_inv_plain(yt[:length], plan, 0, d),
             shard.local_cluster_plain(yt[length:], plan, r, d, False, 1,
                                       clusters)]
    whole = torch_ntt.inv_stages(torch.cat(parts), plan, length, n // 2)
    for omf in (1, 2):
        np.testing.assert_array_equal(
            to_numpy(torch_ntt.inv_final(whole, plan, omf)),
            ref.inv_ntt_radix2(y, plan.q, plan.irop, plan.pirop, 2, omf))


def test_cluster_plain_refuses_what_the_kernels_do_not_take():
    plan = _plan(13)
    x = torch.zeros((1, 1 << 11), dtype=torch.int64)
    with pytest.raises(ValueError, match="at least 4096"):
        shard.local_cluster_plain(x, plan, 0, 4, True, 1, 2)
    x = torch.zeros((1, 1 << 12), dtype=torch.int64)
    with pytest.raises(ValueError, match="a cluster holds"):
        shard.local_cluster_plain(x, plan, 0, 2, True, 1, 32)


def _forced(monkeypatch, clusters):
    """The rule forced to `clusters`; returns the list of the cluster
    plain version's calls (L, C, forward)."""
    monkeypatch.setattr(rns, "cluster_for", lambda *args: clusters)
    calls = []
    plain = shard.local_cluster_plain

    def counting(x, plan, r, shards, forward, omf, c):
        calls.append((x.shape[-1], c, forward))
        return plain(x, plan, r, shards, forward, omf, c)

    monkeypatch.setattr(shard, "local_cluster_plain", counting)
    return calls


def _cpu_mesh(d, nb=1):
    return make_mesh(d, nb, ["cpu"] * (d * nb))


def test_forced_rule_dist_ntt_vs_jax(monkeypatch):
    """N = 2^13 on D = 2 (L = 2^12), C = 4: each position's local pass
    runs the cluster's plain version; forward and inverse equal the JAX
    DistNTT's, lazy outputs included."""
    n, d = 1 << 13, 2
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    calls = _forced(monkeypatch, 4)
    mine = DistNTT(n, q, _cpu_mesh(d))
    theirs = JaxDistNTT(n, q, jax_make_mesh(d, 1))
    rng = np.random.default_rng(11)
    x = rng.integers(0, 4 * q, size=(2, n), dtype=np.uint64)
    np.testing.assert_array_equal(mine.forward(x, 4, 4),
                                  np.asarray(theirs.forward(x, 4, 4)))
    y = rng.integers(0, 2 * q, size=(2, n), dtype=np.uint64)
    np.testing.assert_array_equal(mine.inverse(y, 2, 1),
                                  np.asarray(theirs.inverse(y, 2, 1)))
    assert calls == [(n // d, 4, True)] * d + [(n // d, 4, False)] * d


def test_forced_rule_dist_rns_poly_mult_vs_jax(monkeypatch):
    """The RNS product at N = 2^13 x 2 primes on the (coeff 2, batch 2)
    mesh (a position holds one shard of L = 2^12 of one polynomial), C =
    16: equal to the JAX product and the single-device one."""
    n = 1 << 13
    primes = jnt.generate_primes(2, 45, True, ntt_size=n)
    calls = _forced(monkeypatch, 16)
    rng = np.random.default_rng(12)
    a = rng.integers(0, min(primes), size=(2, 2, n), dtype=np.uint64)
    b = rng.integers(0, min(primes), size=(2, 2, n), dtype=np.uint64)
    got = dist_rns_poly_mult(a, b, n, primes, _cpu_mesh(2, 2))
    np.testing.assert_array_equal(
        got, np.asarray(jax_dist_rns_poly_mult(a, b, n, primes,
                                               jax_make_mesh(2, 2))))
    monkeypatch.setattr(rns, "cluster_for", lambda *args: 1)
    np.testing.assert_array_equal(
        got, rns_poly_mult_mod(a, b, n, primes, device="cpu"))
    # Two primes x two batch rows x two positions x three transforms.
    assert len(calls) == 24 and {c for _, c, _ in calls} == {16}


def test_forced_rule_above_2_14_vs_single_device(monkeypatch):
    """L = 2^15 (N = 2^16, D = 2), C = 8: the local passes above 2^14 take
    the cluster's plain version; the transform equals the flat walk."""
    n, d = 1 << 16, 2
    plan = _plan(16, 50)
    calls = _forced(monkeypatch, 8)
    dist = DistNTT(n, plan.q, _cpu_mesh(d))
    rng = np.random.default_rng(13)
    x = rng.integers(0, plan.q, size=(1, n), dtype=np.uint64)
    y = dist.forward(x, 1, 4)
    np.testing.assert_array_equal(
        y, to_numpy(torch_ntt.fwd_ntt(to_tensor(x, "cpu"), plan, 1, 4)))
    np.testing.assert_array_equal(dist.inverse(y % np.uint64(plan.q), 1, 1),
                                  x)
    assert calls == [(n // d, 8, True)] * d + [(n // d, 8, False)] * d


def test_cluster_count_and_route_on_the_cpu(monkeypatch):
    """On CPU tensors the rule gives C = 1 (the uncut plain pass runs);
    forced, C for chunks of 2^12 .. 2^14 and still 1 below 2^12."""
    x = torch.zeros((3, 1 << 12), dtype=torch.int64)
    assert all(shard.cluster_count(x, log_n, chunks) == 1
               for log_n in (11, 12, 13, 14) for chunks in (1, 3, 256))
    calls = _forced(monkeypatch, 8)
    assert [shard.cluster_count(x, log_n, 3) for log_n in (11, 12, 13, 14)
            ] == [1, 8, 8, 8]
    assert shard.cluster_count(x, 12, 0) == 1
    plan = _plan(13)
    shard.local(x, plan, 1, 2, True, 4)
    shard.local(x[:, :1 << 11].contiguous(), plan, 1, 4, False)
    assert calls == [(1 << 12, 8, True)]


def _occupancy(monkeypatch, active):
    monkeypatch.setattr(rns, "max_active_clusters",
                        lambda log_n, c, device: active(log_n, c))


def test_rule_at_the_grids_a_position_launches(monkeypatch):
    """The table's C at the fifth path's grids (one CTA a shard or
    sub-shard): 16 for one or two 2^14 chunks, 4 for one to three of
    2^12 (the key switch), 1 at 128 of 2^12 (DistNTT at batch 256 on
    (2, 4)) and below 2^12; 1 at a wave and off CUDA."""
    _occupancy(monkeypatch, lambda log_n, c: 10 ** 6)
    assert rns.cluster_for(14, 1, SMS, "cuda") == 16
    assert rns.cluster_for(14, 2, SMS, "cuda") == 16
    assert [rns.cluster_for(12, ctas, SMS, "cuda") for ctas in (1, 2, 3)
            ] == [4, 4, 4]
    assert rns.cluster_for(12, 128, SMS, "cuda") == 1
    assert rns.cluster_for(11, 1, SMS, "cuda") == 1
    assert rns.cluster_for(14, SMS, SMS, "cuda") == 1
    assert rns.cluster_for(14, 1, SMS, "cpu") == 1


def test_rule_refuses_a_cluster_the_card_cannot_hold(monkeypatch):
    _occupancy(monkeypatch, lambda log_n, c: 0)
    for log_n, ctas in ((14, 1), (14, 2), (12, 3)):
        with pytest.raises(RuntimeError, match="no cluster"):
            rns.cluster_for(log_n, ctas, SMS, "cuda")


def _c_params(source, entry):
    text = (CSRC / source).read_text()
    match = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    return [p.strip() for p in match.group(1).split(",")]


@pytest.mark.parametrize("entry", ["hexl_rns_cluster_fwd",
                                   "hexl_rns_cluster_inv"])
def test_c_entries_take_the_wrapper_arguments(entry):
    """`rns.cluster_chunks`'s ctypes argument list matches the C entry's:
    a pointer where it takes a pointer or the stream, an int elsewhere."""
    params = _c_params("ntt_rns.cu", entry)
    assert len(params) == len(rns._CLUSTER_ARGS)
    for param, kind in zip(params, rns._CLUSTER_ARGS):
        pointer = "*" in param or param.startswith("cudaStream_t")
        assert (kind is rns._P) == pointer, param
