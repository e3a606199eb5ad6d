"""The key switch's base-conversion block in its two composite steps:
`conv_fwd` (the other targets base-converted to each q_i and forward-
transformed, one (ds, ds - 1, n) block) and `mac_flush_parts` (the
multiply-accumulate of the block with the target and the key prime's row,
read in three parts). The plain steps against the staged composition they
stand for, `switch` against the staged chain written out, the fused
route's bookkeeping (`block_route`, `block_stats`) with the route forced
on the CPU, and `key_switch_plain` against the benchmark's exact-integer
reference at the shapes of `test_torch_ks_levels.py`. No JAX here."""

import collections
import contextlib
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hexl_tpu_torch.config as port_config
from hebench import reference as ref
from hexl_tpu_torch import key_switch, nt
from hexl_tpu_torch.eltwise import ops, torch_kernels
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import get_plan, get_rns_plan, rns, torch_ntt

ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")

KC = 2


def mixed_basis(n, ds):
    """ds decomposition primes {60, 40 x (ds - 1)} and a 60-bit key prime,
    distinct and = 1 mod 2n (SEAL's CKKS shape; at ds = 1 one 60-bit
    decomposition prime and the key prime)."""
    sixty = nt.generate_primes(2, 59, False, ntt_size=n)
    forty = nt.generate_primes(ds - 1, 39, False, ntt_size=n) if ds > 1 \
        else ()
    return (sixty[0],) + tuple(forty) + (sixty[1],)


def limbs(rng, moduli, n):
    """(len(moduli), n) int64: row j below moduli[j], its first and last
    words q_j - 1, so a 60-bit limb's largest word meets 40-bit rows."""
    x = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
    for j, q in enumerate(moduli):
        x[j, [0, -1]] = q - 1
    return to_tensor(x, "cpu")


@pytest.fixture(params=[False, True], ids=["exact", "approx"])
def approx(request, monkeypatch):
    """The approximate quotients forced off or on."""
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: request.param)
    return request.param


def reduce_rows(x, moduli):
    """Row i of x reduced mod moduli[i] from IMF = q_i, plain."""
    return torch_kernels.reduce_mod_rows(
        x, ops.row_constants(tuple(moduli), x.device), 1, ops.approx_for(x))


def staged_block(x, moduli):
    """The staged composition, step by step: the gather, the rows'
    reduction from IMF = q_i, the stacked forward at (4, 4)."""
    rplan = get_rns_plan(x.shape[-1], moduli)
    return ks.PLAIN.fwd_rns(reduce_rows(ks.others(x), moduli), rplan, 4, 4)


@pytest.mark.parametrize("ds", [2, 3, 5])
@pytest.mark.parametrize("n", [64, 1024])
def test_conv_fwd_is_the_staged_block(n, ds, approx):
    moduli = mixed_basis(n, ds)[:ds]
    x = limbs(np.random.default_rng(n + ds), moduli, n)
    rplan = get_rns_plan(n, moduli)
    want = staged_block(x, moduli)
    assert want.shape == (ds, ds - 1, n)
    assert torch.equal(ks.PLAIN.conv_fwd(x, rplan, moduli), want)
    consts = ops.row_constants(moduli, x.device)
    assert torch.equal(rns.fwd_ntt_rns_conv(x, rplan, consts, approx), want)
    # Row i, batch b holds limb b + (b >= i) mod q_i, forward-transformed.
    for i, q in enumerate(moduli):
        for b in range(ds - 1):
            src = x[b + (b >= i)]
            red = torch_kernels.reduce_mod(src, q, q, 1)
            assert torch.equal(want[i, b], torch_ntt.fwd_ntt(
                red, get_plan(n, q), 4, 4, 64))


def test_conv_fwd_refuses_a_block_of_the_wrong_shape():
    moduli = mixed_basis(64, 3)[:3]
    rplan = get_rns_plan(64, moduli)
    consts = ops.row_constants(moduli, torch.device("cpu"))
    for shape in ((2, 64), (3, 32), (3, 1, 64)):
        with pytest.raises(ValueError):
            rns.fwd_ntt_rns_conv(torch.zeros(shape, dtype=torch.int64),
                                 rplan, consts)


def parts(rng, moduli, ds, kms, n):
    """The block's three parts in the (4, 4) forwards' range and the
    target below each q_i; keys (ds, kc, kms, n) below each modulus."""
    rows = list(moduli[:ds]) + [moduli[-1]]

    def below(bound, shape):
        return to_tensor(rng.integers(0, bound, shape, dtype=np.uint64),
                         "cpu")

    off = torch.stack([below(4 * q, (ds - 1, n)) for q in rows[:ds]])
    diag = torch.stack([below(q, (n,)) for q in rows[:ds]])
    last = below(4 * rows[-1], (ds, n))
    keys = torch.stack([torch.stack([torch.stack(
        [below(q, (n,)) for q in moduli]) for _ in range(KC)])
        for _ in range(ds)])
    return off, diag, last, keys


@pytest.mark.parametrize("ds", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [64, 1024])
def test_mac_flush_parts_is_the_assembled_flush(n, ds, approx):
    """At ds = 1 `off` is an empty (1, 0, n) block: row 0's one trip is the
    target, the key prime's row reads `last`."""
    moduli = mixed_basis(n, ds)
    kms = len(moduli)
    off, diag, last, keys = parts(np.random.default_rng(7 * n + ds),
                                  moduli, ds, kms, n)
    c = ks.constants(moduli, tuple(pow(moduli[-1], -1, q)
                                   for q in moduli[:ds]), ds,
                     torch.device("cpu"))
    # The assembled block, row by row: diag at j == i, off's rows around
    # it, the key prime's row last.
    t = torch.stack([torch.stack([diag[i] if j == i else off[i][j - (j > i)]
                                  for j in range(ds)]) for i in range(ds)]
                    + [last])
    assert torch.equal(ks.assemble(off, diag, last), t)
    want = ks.mac_flush_plain(t, keys, c.mac, ds, KC, kms, approx)
    assert torch.equal(ks.PLAIN.mac_flush_parts(off, diag, last, keys, c, ds,
                                                KC, kms, approx), want)
    assert torch.equal(ks.mac_flush_parts(off, diag, last, keys, c, ds, KC,
                                          kms, approx), want)


def ks_args(n, ds, seed):
    """A top-level key switch over the mixed basis: (result, target, keys,
    n, ds, kms, kc, moduli, msf), int64 tensors on the CPU."""
    moduli = mixed_basis(n, ds)
    rng = np.random.default_rng(seed)

    def rows(qs, lead=()):
        return to_tensor(np.stack([rng.integers(0, q, lead + (n,),
                                                dtype=np.uint64)
                                   for q in qs], axis=len(lead)), "cpu")

    keys = rows(moduli, (ds, KC))
    msf = tuple(pow(moduli[-1], -1, q) for q in moduli[:ds])
    return (rows(moduli[:ds], (KC,)), rows(moduli[:ds]), keys, n, ds,
            ds + 1, KC, moduli, msf)


def staged_switch(t, keys, n, ds, kms, kc, moduli, msf):
    """`switch`'s stacked branch before the composite steps, written out
    on the plain versions: (tpp, t_ntt)."""
    c = ks.constants(moduli, msf, ds, t.device)
    approx = ops.approx_for(t)
    rplan = get_rns_plan(n, moduli[:ds])
    plan_k = get_plan(n, moduli[-1])
    t_intt = rns.inv_ntt_rns_plain(t, rplan, 2, 1)
    conv = reduce_rows(ks.others(t_intt), moduli[:ds])
    key_row = torch_ntt.fwd_ntt(ks.PLAIN.reduce(t_intt, moduli[-1]), plan_k,
                                4, 4)
    t_rows = ks.assemble(rns.fwd_ntt_rns_plain(conv, rplan, 4, 4), t,
                         key_row)
    tpp = ks.mac_flush_plain(t_rows, keys, c.mac, ds, kc, kms,
                             ks.flush_approx(ks.PLAIN, moduli, ds, approx))
    t_last = torch_ntt.inv_ntt(tpp[ds], plan_k, 2, 2)
    t_ntt = rns.fwd_ntt_rns_plain(ks.spread_plain(t_last, c, approx), rplan,
                                  4, 4)
    return tpp, t_ntt


@pytest.mark.parametrize("ds", [2, 3, 5])
def test_switch_through_plain_is_the_staged_chain(ds, approx):
    result, t, keys, *rest = ks_args(64, ds, seed=ds)
    tpp, t_ntt, _, _ = ks.switch(ks.PLAIN, t, keys, *rest)
    want_tpp, want_ntt = staged_switch(t, keys, *rest)
    assert torch.equal(tpp, want_tpp) and torch.equal(t_ntt, want_ntt)
    # The wrappers run the plain versions on the CPU and count no
    # card call.
    before = collections.Counter(ks.block_stats)
    tpp_w, t_ntt_w, _, _ = ks.switch(ks.WRAPPERS, t, keys, *rest)
    assert torch.equal(tpp_w, want_tpp) and torch.equal(t_ntt_w, want_ntt)
    assert ks.block_stats == before


def test_block_route_is_none_off_the_card():
    x = torch.zeros((3, 1 << 15), dtype=torch.int64)
    assert ks.block_route(x, 1 << 15, 3) is None
    assert not rns.conv_fused(x, 1 << 15, 3)


@pytest.fixture
def forced_route(monkeypatch):
    """`block_route` forced to "fused" on the CPU (the fused steps then run
    their plain versions) and `block_stats` fresh."""
    monkeypatch.setattr(ks, "block_route", lambda x, n, ds: "fused")
    monkeypatch.setattr(ks, "block_stats", collections.Counter())
    return ks


class FakeGraph:
    def replay(self):
        pass


def test_a_replay_counts_the_route_its_capture_held(monkeypatch,
                                                     forced_route):
    """The eager chain counts its route; a capture's count is held on its
    entry and counted again by each replay, as its launches are."""

    @contextlib.contextmanager
    def graph(*args, **kwargs):
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", SimpleNamespace)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 0)
    result, t, keys, *rest = ks_args(64, 3, seed=11)
    want_tpp, want_ntt = staged_switch(t, keys, *rest)
    tpp, t_ntt, _, _ = ks.switch(ks.WRAPPERS, t, keys, *rest)
    assert torch.equal(tpp, want_tpp) and torch.equal(t_ntt, want_ntt)
    assert ks.block_stats == {"fused": 1}
    entry = ks.capture(t, keys, *rest)
    assert entry.routes == {"fused": 1}
    assert ks.block_stats == {"fused": 1}
    for calls in (2, 3):
        ks.graph(entry, t)
        assert ks.block_stats == {"fused": calls}


@pytest.mark.parametrize("ds,kms", [(3, 6), (1, 6)])
def test_key_switch_plain_is_the_reference_below_the_top_level(ds, kms,
                                                                approx):
    """At test_torch_ks_levels.py's shapes (n = 64, a {60, 40 x 4, 60} key,
    level ds of kms 6), `key_switch_plain` and `key_switch` on the CPU
    equal the benchmark's exact-integer reference."""
    n = 64
    sixty = nt.generate_primes(2, 59, False, ntt_size=n)
    moduli = ((sixty[0],) + tuple(nt.generate_primes(kms - 2, 39, False,
                                                     ntt_size=n))
              + (sixty[1],))
    rng = np.random.default_rng(ds * 10 + kms + approx)

    def rows(qs, lead=()):
        return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                         for q in qs], axis=len(lead))

    keys = rows(moduli, (kms - 1, KC))[:ds]
    msf = [pow(moduli[-1], -1, q) for q in moduli[:ds]]
    result, target = rows(moduli[:ds], (KC,)), rows(moduli[:ds])
    args = (result, target, n, ds, kms, ds + 1, KC, moduli, keys, msf)
    got = ks.key_switch_plain(*args, device="cpu")
    want = ref.key_switch(*(to_tensor(x, "cpu") for x in (result, target,
                                                           keys)),
                          msf, ref.Tables(n, moduli))
    np.testing.assert_array_equal(got, to_numpy(want))
    np.testing.assert_array_equal(key_switch(*args, device="cpu"), got)
