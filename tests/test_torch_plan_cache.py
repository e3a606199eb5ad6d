"""The port's plan cache: its disk form against the JAX package's, its
clear hooks, and `get_plan(..., device=)`.

A plan file written by `hexl_tpu.ntt.plan.save_plan_cache` loads into the
port and drives transforms bit-equal to the JAX package's, and the
reverse, including q < 2^30 at N >= 1024 (the single-word route); damaged
files are refused with the JAX package's ValueErrors. Each test works on
caches of its own (monkeypatched), so the caches of other tests in the
process are left as they were.
"""

import importlib

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jax_nt
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu.ntt import plan as jax_plan
from hexl_tpu_torch import NTT, nt
from hexl_tpu_torch.ntt import mxu_ntt, shard
from hexl_tpu_torch.ntt import plan as plan_mod
from hexl_tpu_torch.parallel import dist_ntt, make_mesh

dyadic = importlib.import_module("hexl_tpu_torch.experimental.dyadic")
ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")

# (N, q bits): the flat walk, the single-word route (q < 2^30 from N =
# 1024 on) and the 64-bit walk at 2^12.
CARRIED = [(64, 50), (2048, 29), (4096, 60)]


@pytest.fixture
def own_caches(monkeypatch):
    """Empty plan caches for both packages, restored afterwards."""
    monkeypatch.setattr(plan_mod, "_PLAN_CACHE", {})
    monkeypatch.setattr(jax_plan, "_PLAN_CACHE", {})


def _prime(bits, n):
    return jax_nt.generate_primes(1, bits, True, ntt_size=n)[0]


def _inputs(n, q, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, q, size=(2, n), dtype=np.uint64)


def _port_pair(n, q, x):
    e = NTT(n, q, device="cpu")
    y = e.forward(x)
    return y, e.forward(x, 1, 4), e.inverse(y)


def _jax_pair(n, q, x):
    e = JaxNTT(n, q)
    y = np.asarray(e.forward(x))
    return y, np.asarray(e.forward(x, 1, 4)), np.asarray(e.inverse(y))


def test_plan_cache_save_load(own_caches, tmp_path):
    """The counterpart of tests/test_ntt.py::test_plan_cache_save_load."""
    n = 2048
    q = nt.generate_primes(1, 50, True, ntt_size=n)[0]
    p1 = plan_mod.get_plan(n, q)
    path = str(tmp_path / "plans.npz")
    assert plan_mod.save_plan_cache(path) >= 1

    plan_mod.clear_plan_cache()
    assert plan_mod.load_plan_cache(path) >= 1
    p2 = plan_mod.get_plan(n, q)
    assert p2 is not p1
    np.testing.assert_array_equal(p2.rop, p1.rop)
    np.testing.assert_array_equal(p2.pirop, p1.pirop)
    assert p2.root == p1.root and p2.inv_n_w == p1.inv_n_w

    # The restored plan drives a correct transform.
    ntt = NTT(n, q, device="cpu")
    assert ntt.plan is p2
    rng = np.random.default_rng(11)
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    np.testing.assert_array_equal(ntt.inverse(ntt.forward(x)), x)


@pytest.mark.parametrize("n,q_bits", CARRIED)
def test_jax_file_loads_into_the_port(own_caches, tmp_path, n, q_bits):
    q = _prime(q_bits, n)
    jp = jax_plan.get_plan(n, q)
    path = str(tmp_path / "jax_plans.npz")
    assert jax_plan.save_plan_cache(path) == 1
    assert plan_mod.load_plan_cache(path) == 1
    loaded = plan_mod.get_plan(n, q)
    assert loaded.root == jp.root
    assert loaded.single_word == (q < 1 << 30 and n >= 1024)
    for name in ("rop", "prop", "irop", "pirop"):
        np.testing.assert_array_equal(getattr(loaded, name),
                                      getattr(jp, name))
    x = _inputs(n, q, n + q_bits)
    for got, want in zip(_port_pair(n, q, x), _jax_pair(n, q, x)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,q_bits", CARRIED)
def test_port_file_loads_into_jax(own_caches, tmp_path, n, q_bits):
    q = _prime(q_bits, n)
    plan_mod.get_plan(n, q)
    path = str(tmp_path / "port_plans.npz")
    assert plan_mod.save_plan_cache(path) == 1
    assert jax_plan.load_plan_cache(path) == 1
    jp = jax_plan.get_plan(n, q)
    built = plan_mod.NttPlan.build(n, q)
    assert jp.root == built.root
    np.testing.assert_array_equal(jp.pirop, built.pirop)
    x = _inputs(n, q, n + q_bits + 1)
    for got, want in zip(_jax_pair(n, q, x), _port_pair(n, q, x)):
        np.testing.assert_array_equal(got, want)


def _damaged(tmp_path, name, edit):
    """A port plan file for (256, 50-bit) with `edit` applied to its
    arrays; returns (path, n, q)."""
    n = 256
    q = _prime(50, n)
    p = plan_mod.NttPlan.build(n, q)
    key = f"{n}_{q}"
    arrays = {f"{t}_{key}": getattr(p, t).copy()
              for t in ("rop", "irop", "prop", "pirop")}
    arrays[f"root_{key}"] = np.uint64(p.root)
    edit(arrays, key, p)
    path = str(tmp_path / f"{name}.npz")
    np.savez_compressed(path, **arrays)
    return path, n, q


def _flip_last(table):
    def edit(arrays, key, p):
        arrays[f"{table}_{key}"][-1] ^= np.uint64(1)
    return edit


def _wrong_root(arrays, key, p):
    arrays[f"root_{key}"] = np.uint64(p.root + 1)


def _short_tables(arrays, key, p):
    arrays[f"rop_{key}"] = arrays[f"rop_{key}"][:-1]


@pytest.mark.parametrize("name,edit,message", [
    ("rop", _flip_last("rop"), "corrupt rop table for (N={n}, q={q})"),
    ("prop", _flip_last("prop"), "corrupt prop table for (N={n}, q={q})"),
    ("irop", _flip_last("irop"), "corrupt irop table for (N={n}, q={q})"),
    ("pirop", _flip_last("pirop"), "corrupt irop table for (N={n}, q={q})"),
    ("root", _wrong_root, "stored root {root} is not a primitive {two_n}-th "
                          "root of unity mod {q}"),
    ("shape", _short_tables, "corrupt plan tables for (N={n}, q={q})"),
])
def test_damaged_files_raise_the_jax_errors(own_caches, tmp_path, name, edit,
                                            message):
    path, n, q = _damaged(tmp_path, name, edit)
    root = int(np.load(path)[f"root_{n}_{q}"])
    want = message.format(n=n, q=q, root=root, two_n=2 * n)
    with pytest.raises(ValueError) as mine:
        plan_mod.load_plan_cache(path)
    assert str(mine.value) == want
    assert plan_mod._PLAN_CACHE == {}
    if name != "shape":       # the JAX loader checks rop/irop shapes only
        with pytest.raises(ValueError) as theirs:
            jax_plan.load_plan_cache(path)
        assert str(theirs.value) == want


def test_clear_empties_every_derived_cache(own_caches, monkeypatch):
    """After clear_plan_cache() no derived cache holds a plan or its
    device tables: the MXU plans, the shards' twiddles, the composites'
    constants and the distributed engines."""
    monkeypatch.setattr(mxu_ntt, "_MXU_CACHE", {})
    n = 1 << 15
    q = nt.generate_primes(1, 50, True, ntt_size=n)[0]
    moduli = nt.generate_primes(3, 40, True, ntt_size=1024)
    msf = tuple(nt.inverse_mod(moduli[-1] % p, p) for p in moduli[:2])
    cpu = torch.device("cpu")
    plan = plan_mod.get_plan(n, q, device="cpu")
    mxu_ntt.get_mxu_plan(256, nt.generate_primes(1, 50, True,
                                                 ntt_size=256)[0])
    shard.intra_twiddles(plan, 0, 1, True, cpu)
    ks.constants(tuple(moduli), msf, 2, cpu)
    dyadic.row_constants(tuple(moduli), cpu)
    dist_ntt.get_dist_ntt(1024, moduli[0], make_mesh(2, 1, ["cpu"] * 2))
    assert plan_mod._PLAN_CACHE and mxu_ntt._MXU_CACHE
    assert dist_ntt._DIST_CACHE
    caches = (shard.intra_twiddles, ks.constants, dyadic.row_constants)
    assert all(c.cache_info().currsize for c in caches)

    plan_mod.clear_plan_cache()
    assert plan_mod._PLAN_CACHE == {} and mxu_ntt._MXU_CACHE == {}
    assert dist_ntt._DIST_CACHE == {}
    assert [c.cache_info().currsize for c in caches] == [0, 0, 0]


def test_clear_runs_registered_hooks(own_caches, monkeypatch):
    monkeypatch.setattr(plan_mod, "_CLEAR_HOOKS", [])
    calls = []
    plan_mod.register_clear_hook(lambda: calls.append(len(
        plan_mod._PLAN_CACHE)))
    plan_mod.get_plan(16, nt.generate_primes(1, 30, True, ntt_size=16)[0])
    plan_mod.clear_plan_cache()
    assert calls == [0]      # after the plans are dropped


def test_get_plan_with_a_device(own_caches):
    n = 1024
    q = nt.generate_primes(1, 29, True, ntt_size=n)[0]
    plan = plan_mod.get_plan(n, q, device="cpu")
    assert plan is plan_mod.get_plan(n, q)
    assert list(plan._dev) == ["cpu"]
    tabs = plan._dev["cpu"]
    assert set(tabs) == {"rop", "prop", "irop", "pirop", "prop32", "pirop32"}
    np.testing.assert_array_equal(tabs["rop"].numpy().view(np.uint64),
                                  plan.rop)
