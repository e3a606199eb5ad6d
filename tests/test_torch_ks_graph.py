"""The key switch's graph path (`experimental/key_switch.py`) on the CPU:
what its key holds, the cache's bookkeeping driven with a stand-in for
the capture, the clear hook, CPU operands bypassing it, and `pipeline`
as `switch` then the fold. The capture and replay themselves run only on
the card (`tests/test_torch_gpu.py`)."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hexl_tpu_torch import config, key_switch, nt
from hexl_tpu_torch.ntt import clear_plan_cache, hier, rns
from hexl_tpu_torch.utils import profiling

# The module, which the function of its name shadows in `experimental`.
ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")


@pytest.fixture(autouse=True)
def empty_graphs():
    ks.graphs.clear()
    ks.graph_stats.clear()
    yield
    ks.graphs.clear()
    ks.graph_stats.clear()


def ks_args(n=64, ds=3, kc=2, repeat=False, seed=0):
    """The key switch's arguments on the CPU: ds decomposition primes of
    40 bits (the second equal to the first where `repeat`), a 41-bit key
    prime."""
    moduli = nt.generate_primes(ds, 40, True, ntt_size=n)
    if repeat:
        moduli[1] = moduli[0]
    moduli = tuple(moduli) + tuple(nt.generate_primes(1, 41, True,
                                                      ntt_size=n))
    rng = np.random.default_rng(seed)

    def rows(count):
        return torch.from_numpy(np.stack(
            [rng.integers(0, q, n, dtype=np.uint64) for q in moduli[:count]]
        ).view(np.int64))

    keys = torch.stack([torch.stack([rows(ds + 1) for _ in range(kc)])
                        for _ in range(ds)])
    result = torch.stack([rows(ds) for _ in range(kc)])
    msf = tuple(pow(moduli[-1], -1, q) for q in moduli[:ds])
    return result, rows(ds), keys, n, ds, ds + 1, kc, moduli, msf


def key_of(args, stream=7):
    _, t, keys, n, ds, kms, kc, moduli, msf = args
    return ks.graph_key(stream, t, keys, n, ds, kms, kc, moduli, msf)


# Each part of the key, changed alone: (name, change), where change takes
# the arguments and the monkeypatch and gives the key.
def _other_keys(args):
    return args[:2] + (args[2].clone(),) + args[3:]


KEY_PARTS = {
    "stream": lambda a, mp: key_of(a, stream=8),
    "moduli": lambda a, mp: key_of(a[:7] + (a[7][:-1] + (a[7][0],),) + a[8:]),
    "msf": lambda a, mp: key_of(a[:8] + ((a[8][0] + 1,) + a[8][1:],)),
    "keys_address": lambda a, mp: key_of(_other_keys(a)),
    "keys_shape": lambda a, mp: key_of(a[:2] + (a[2][:, :1],) + a[3:]),
    "n": lambda a, mp: key_of(ks_args(n=128)),
    "ds": lambda a, mp: key_of(ks_args(ds=2)),
    "kc": lambda a, mp: key_of(ks_args(kc=3)),
    "approx": lambda a, mp: (mp.setattr(config, "approx_butterflies",
                                        lambda device: True), key_of(a))[1],
    "cluster_rule": lambda a, mp: (mp.setattr(rns, "cluster_for",
                                              lambda *x: 1), key_of(a))[1],
    "cross_rule": lambda a, mp: (mp.setattr(hier, "cross_form",
                                            lambda *x: "column"),
                                 key_of(a))[1],
}


@pytest.mark.parametrize("part", sorted(KEY_PARTS))
def test_the_graph_key_changes_with_each_part(part, monkeypatch):
    args = ks_args()
    base = key_of(args)
    assert key_of(args) == base
    assert KEY_PARTS[part](args, monkeypatch) != base


def test_the_graph_key_leaves_out_the_target_and_result():
    """A call's own target and result are copied in and folded outside the
    graph, so fresh operands of one shape share its key."""
    a, b = ks_args(seed=1), ks_args(seed=2)
    b = b[:2] + (a[2],) + b[3:]
    assert not torch.equal(a[1], b[1])
    assert key_of(a) == key_of(b)


@pytest.mark.parametrize("ds,repeat", [(1, False), (3, False), (3, True)])
def test_cpu_operands_leave_the_graphs_alone(ds, repeat):
    result, t, keys, n, ds, kms, kc, moduli, msf = ks_args(ds=ds,
                                                           repeat=repeat)
    for _ in range(3):
        key_switch(result, t, n, ds, kms, kms, kc, moduli, keys, msf)
    with profiling.recording():
        key_switch(result, t, n, ds, kms, kms, kc, moduli, keys, msf)
    assert not ks.graphs and not ks.graph_stats


def test_clear_plan_cache_empties_the_graphs():
    ks.graphs[("seen",)] = None
    ks.graphs[("captured",)] = SimpleNamespace(t_static=torch.zeros(2))
    clear_plan_cache()
    assert not ks.graphs


def test_lookup_runs_eagerly_then_captures_then_replays():
    made = []

    def make():
        made.append(SimpleNamespace(t_static=torch.zeros(1)))
        return made[-1]

    assert ks.lookup("k", make) is None
    assert made == []
    entry = ks.lookup("k", make)
    assert made == [entry]
    assert all(ks.lookup("k", make) is entry for _ in range(3))
    assert made == [entry]
    assert dict(ks.graph_stats) == {"eager": 1, "captures": 1, "replays": 3}


def test_a_failed_capture_raises_and_is_tried_again():
    def fail():
        raise RuntimeError("capture failed")

    ks.lookup("k", fail)
    with pytest.raises(RuntimeError, match="capture failed"):
        ks.lookup("k", fail)
    assert ks.graphs["k"] is None
    entry = SimpleNamespace(t_static=torch.zeros(1))
    assert ks.lookup("k", lambda: entry) is entry


def test_the_cache_evicts_the_least_recently_used_key():
    def make():
        return SimpleNamespace(t_static=torch.zeros(1))

    for k in range(ks.GRAPH_CACHE):
        assert ks.lookup(k, make) is None
    first = ks.lookup(0, make)           # key 0 captured, now most recent
    assert ks.lookup(ks.GRAPH_CACHE, make) is None
    assert len(ks.graphs) == ks.GRAPH_CACHE
    assert 1 not in ks.graphs and 0 in ks.graphs
    assert list(ks.graphs)[-2:] == [0, ks.GRAPH_CACHE]
    assert ks.lookup(0, make) is first
    assert ks.lookup(1, make) is None    # evicted: seen anew
    assert 2 not in ks.graphs
    assert dict(ks.graph_stats) == {"eager": ks.GRAPH_CACHE + 2,
                                    "captures": 1, "replays": 1}


@pytest.mark.parametrize("ds,repeat", [(1, False), (2, False), (3, False),
                                       (3, True)])
def test_pipeline_is_switch_then_the_fold(ds, repeat):
    result, t, keys, n, ds, kms, kc, moduli, msf = ks_args(ds=ds,
                                                           repeat=repeat)
    rest = (n, ds, kms, kc, moduli, msf)
    tpp, t_ntt, c, approx = ks.switch(ks.PLAIN, t, keys, *rest)
    assert tpp.shape == (ds + 1, kc, n) and t_ntt.shape == (ds, kc, n)
    folded = ks.PLAIN.fold(result, tpp, t_ntt, c, approx)
    assert torch.equal(folded, ks.pipeline(ks.PLAIN, result, t, keys, *rest))
    assert torch.equal(folded, key_switch(result, t, n, ds, kms, kms, kc,
                                          moduli, keys, msf))
