"""The cluster form of the stacked RNS transform (plain versions, CPU).

K1.rns.cl and K6.rns.cl run a transform (N = 2^12 .. 2^14) or 2^14 shard
on a cluster of C CTAs; their plain version is each row's flat walk cut
where the kernels cut it (`rns.fwd_ntt_rns_cluster_plain`,
`inv_ntt_rns_cluster_plain`). Here: that walk against
`hexl_tpu.ntt.rns` at N = 2^12 and 2^13 for every C, k = 1 and 3, and the
key switch's (IMF, OMF) pairs; above 2^14 (the shards) against the NumPy
oracle `hexl_tpu.ref`; the rule `rns.cluster_for` (C = 1 at a wave, no C
beyond what the card holds at once, a refused query raises, the table's
entries); and `key_switch` with the rule forced to C > 1 on the CPU (its
stacked and one-prime transforms then run the cluster form's plain
version) against the JAX `key_switch`. Lazy outputs included, every
comparison is exact equality.
"""

import functools

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.experimental import key_switch as jax_key_switch
from hexl_tpu.ntt import RnsNTT as JaxRnsNTT
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu_torch import key_switch
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import cuda_ntt, get_plan, hier, rns, torch_ntt
from tests.test_torch_rns_stacked import _basis, _residues
from tests.torch_threads import one_torch_thread  # noqa: F401

# The key switch's (forward, IMF, OMF): its forwards at (4, 4), its
# inverses at (2, 1) and (2, 2); and (1, 1) both ways.
PAIRS = ((True, 4, 4), (False, 2, 1), (False, 2, 2), (True, 1, 1),
         (False, 1, 1))
SMS = 132


@functools.lru_cache(maxsize=None)
def _jax_case(n, k, case):
    """(moduli, x, the JAX stacked transform of x) for one (N, k, pair)."""
    forward, imf, omf = PAIRS[case]
    moduli = _basis(n, (50, 62, 29)[:k])
    x = _residues(np.random.default_rng(n + 7 * k + case), moduli, (2, n),
                  imf)
    theirs = JaxRnsNTT(n, moduli)
    fn = theirs.forward if forward else theirs.inverse
    return moduli, x, np.asarray(fn(x, imf, omf))


@pytest.mark.parametrize("n", [1 << 12, 1 << 13])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("clusters", rns.CLUSTER_SIZES)
@pytest.mark.parametrize("case", range(len(PAIRS)))
def test_cluster_plain_vs_jax(n, k, clusters, case):
    forward, imf, omf = PAIRS[case]
    moduli, x, want = _jax_case(n, k, case)
    rplan = rns.get_rns_plan(n, moduli)
    fn = (rns.fwd_ntt_rns_cluster_plain if forward
          else rns.inv_ntt_rns_cluster_plain)
    got = fn(to_tensor(x, "cpu"), rplan, clusters, imf, omf)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("log_n", [15, 16])
@pytest.mark.parametrize("clusters", [2, 16])
@pytest.mark.parametrize("forward,imf,omf", [(True, 4, 4), (True, 1, 1),
                                             (False, 2, 1), (False, 2, 2)])
def test_cluster_plain_large_vs_oracle(log_n, clusters, forward, imf, omf):
    """Above 2^14 (the shards of the split) against `hexl_tpu.ref`, row
    by row."""
    n = 1 << log_n
    moduli = _basis(n, (29, 62))
    rng = np.random.default_rng(log_n + clusters + imf + 3 * omf)
    x = _residues(rng, moduli, (n,), imf)
    rplan = rns.get_rns_plan(n, moduli)
    fn = (rns.fwd_ntt_rns_cluster_plain if forward
          else rns.inv_ntt_rns_cluster_plain)
    got = to_numpy(fn(to_tensor(x, "cpu"), rplan, clusters, imf, omf))
    for i, q in enumerate(moduli):
        jp = jax_get_plan(n, q)
        if forward:
            want = ref.fwd_ntt_radix2(x[i], q, jp.rop, jp.prop, imf, omf)
        else:
            want = ref.inv_ntt_radix2(x[i], q, jp.irop, jp.pirop, imf, omf)
        np.testing.assert_array_equal(got[i], want, err_msg=f"row {i}")


def test_cluster_plain_refuses_what_the_kernels_do_not_take():
    rplan = rns.get_rns_plan(1 << 11, _basis(1 << 11, (50,)))
    x = torch.zeros((1, 1, 1 << 11), dtype=torch.int64)
    with pytest.raises(ValueError, match="N >= 4096"):
        rns.fwd_ntt_rns_cluster_plain(x, rplan, 2)
    rplan = rns.get_rns_plan(1 << 12, _basis(1 << 12, (50,)))
    x = torch.zeros((1, 1, 1 << 12), dtype=torch.int64)
    with pytest.raises(ValueError, match="a cluster holds"):
        rns.inv_ntt_rns_cluster_plain(x, rplan, 32)


def _occupancy(monkeypatch, active):
    """rns.max_active_clusters as `active(log_n, C)`."""
    monkeypatch.setattr(rns, "max_active_clusters",
                        lambda log_n, c, device: active(log_n, c))


def test_cluster_for_keeps_one_cta_at_a_wave(monkeypatch):
    _occupancy(monkeypatch, lambda log_n, c: 10 ** 6)
    for log_n in range(6, 15):
        for ctas in (SMS, SMS + 1, 4 * SMS, 100_000):
            assert rns.cluster_for(log_n, ctas, SMS, "cuda") == 1
    # On the CPU there is no cluster.
    assert all(rns.cluster_for(log_n, ctas, SMS, "cpu") == 1
               for log_n in (12, 13, 14) for ctas in range(1, SMS))


@pytest.mark.parametrize("fits", [lambda c: SMS // c, lambda c: 66 // c,
                                  lambda c: max(1, 8 // c)])
def test_cluster_for_stays_within_the_occupancy(fits, monkeypatch):
    """Whatever the card holds, the rule's C is 1, a table size, and one
    whose clusters all fit at once."""
    _occupancy(monkeypatch, lambda log_n, c: fits(c))
    for log_n in range(10, 15):
        for ctas in range(1, SMS):
            c = rns.cluster_for(log_n, ctas, SMS, "cuda")
            assert c == 1 or (c in rns.CLUSTER_SIZES and ctas <= fits(c))
            table = dict(rns.CLUSTER_TABLE.get(log_n, ()))
            assert c <= max([1] + [v for most, v in table.items()
                                   if ctas <= most])


def test_cluster_for_refuses_a_cluster_the_card_cannot_hold(monkeypatch):
    _occupancy(monkeypatch, lambda log_n, c: 0)
    picked = [(log_n, most) for log_n, entries in rns.CLUSTER_TABLE.items()
              for most, c in entries if c > 1]
    for log_n, ctas in picked:
        with pytest.raises(RuntimeError, match="no cluster"):
            rns.cluster_for(log_n, min(ctas, SMS - 1), SMS, "cuda")


def test_cluster_table_is_well_formed():
    for log_n, entries in rns.CLUSTER_TABLE.items():
        assert 12 <= log_n <= 14
        most = [m for m, _ in entries]
        assert most == sorted(most) and most[-1] < SMS
        assert all(c in (1,) + rns.CLUSTER_SIZES for _, c in entries)


def _count_cluster_plain(monkeypatch):
    calls = []
    plain = rns._cluster_plain

    def counting(x, rplan, clusters, forward, omf, whole):
        calls.append((rplan.k, clusters, forward, whole))
        return plain(x, rplan, clusters, forward, omf, whole)

    monkeypatch.setattr(rns, "_cluster_plain", counting)
    return calls


@pytest.mark.parametrize("n,ds", [(1 << 12, 3), (1 << 15, 2)])
def test_key_switch_cluster_vs_jax(n, ds, monkeypatch):
    """The rule forced to C = 4: the key switch's stacked transforms and
    its key prime's (`cuda_ntt`, and `hier`'s local pass above 2^14) take
    the cluster form's plain version, and the output is the JAX key
    switch's."""
    kc, kms = 2, ds + 1
    moduli = _basis(n, (49,) * (ds + 1))
    qk = moduli[-1]
    rng = np.random.default_rng(n + ds)
    t_target = _residues(rng, moduli[:ds], (n,))
    keys = np.stack([np.stack([_residues(rng, moduli, (n,))
                               for _ in range(kc)]) for _ in range(ds)])
    msf = [jnt.inverse_mod(qk % q, q) for q in moduli[:ds]]
    result = np.stack([_residues(rng, moduli[:ds], (n,)) for _ in range(kc)])
    monkeypatch.setattr(rns, "cluster_for", lambda *args: 4)
    calls = _count_cluster_plain(monkeypatch)
    got = key_switch(result, t_target, n, ds, kms, kms, kc, moduli, keys,
                     msf, device="cpu")
    want = np.asarray(jax_key_switch(result, t_target, n, ds, kms, kms, kc,
                                     moduli, keys, msf))
    np.testing.assert_array_equal(got, want)
    # The target's inverse, the key prime's forward (the local pass alone
    # above 2^14), the converted block's forward, the key prime's inverse,
    # the mod-down's forward.
    whole = n <= hier.LOCAL_N
    assert calls == [(ds, 4, False, True), (1, 4, True, whole),
                     (ds, 4, True, True), (1, 4, False, whole),
                     (ds, 4, True, True)]


@pytest.mark.parametrize("log_n", [12, 14, 15])
def test_one_prime_calls_take_the_cluster_route(log_n, monkeypatch):
    """A 64-bit exact one-prime call whose rule picks C > 1 runs the
    cluster form through the one-row plan of its prime; bit for bit the
    flat walk."""
    n = 1 << log_n
    plan = get_plan(n, _basis(n, (60,))[0])
    rng = np.random.default_rng(log_n)
    x = to_tensor(rng.integers(0, 4 * plan.q, size=(3, n), dtype=np.uint64),
                  "cpu")
    monkeypatch.setattr(rns, "cluster_for", lambda *args: 8)
    calls = _count_cluster_plain(monkeypatch)
    fwd = cuda_ntt.fwd_ntt(x, plan, 4, 4)
    inv = cuda_ntt.inv_ntt(fwd, plan, 2, 1)
    assert torch.equal(fwd, torch_ntt.fwd_ntt(x, plan, 4, 4))
    assert torch.equal(inv, torch_ntt.inv_ntt(fwd, plan, 2, 1))
    whole = n <= hier.LOCAL_N
    assert calls == [(1, 8, True, whole), (1, 8, False, whole)]
    # The lean schemes and the single word keep their kernels.
    calls.clear()
    cuda_ntt.fwd_ntt(x, plan, 4, 4, 64, "lean8")
    assert calls == []
