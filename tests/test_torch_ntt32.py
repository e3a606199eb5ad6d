"""The port's single-word NTT for q < 2^30 (plain versions, CPU) against JAX.

The JAX single-word path (`hexl_tpu/ntt/ntt32.py`) is exact everywhere, so
every comparison here is bit for bit, lazy outputs included: the plain walk
against the XLA bodies `fwd_ntt32`/`inv_ntt32` (at N = 2^10, 2^14 and
2^17, one compile per (N, q) for both directions and both OMFs), against
the Pallas kernel `_run_pallas` in interpret mode at N = 2^10, and the
routing rule of the public `NTT`, which is the JAX engine's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu.ntt import ntt32 as jax_ntt32
from hexl_tpu_torch import NTT, get_plan
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import cuda_ntt, ntt32, torch_ntt
from tests.torch_threads import one_torch_thread  # noqa: F401


def _prime(q_bits, n):
    return jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]


def _jax_all(jp):
    """One compiled function: fwd OMF 1 and 4, inv OMF 1 and 2."""
    def run(x, y):
        return (jax_ntt32.fwd_ntt32(x, jp, 1, 1),
                jax_ntt32.fwd_ntt32(x, jp, 1, 4),
                jax_ntt32.inv_ntt32(y, jp, 1, 1),
                jax_ntt32.inv_ntt32(y, jp, 1, 2))
    return jax.jit(run)


@pytest.mark.parametrize("log_n,q_bits", [(10, 20), (10, 27), (10, 29),
                                          (14, 20), (14, 27), (14, 29),
                                          (17, 27), (17, 29)])
def test_plain_walk_vs_jax_ntt32(log_n, q_bits):
    """(No 20-bit prime is 1 mod 2^18, so 2^17 runs 27 and 29 bits.) The
    forward input spans [0, 4q) and the inverse's [0, 2q), the widest
    ranges of their IMFs; the JAX bodies read no IMF."""
    n = 1 << log_n
    q = _prime(q_bits, n)
    plan, jp = get_plan(n, q), jax_get_plan(n, q)
    assert plan.single_word
    rng = np.random.default_rng(log_n * 100 + q_bits)
    x = rng.integers(0, 4 * q, size=(2, n), dtype=np.uint64)
    y = rng.integers(0, 2 * q, size=(2, n), dtype=np.uint64)
    theirs = _jax_all(jp)(jnp.asarray(x.astype(np.uint32)),
                          jnp.asarray(y.astype(np.uint32)))
    xt, yt = to_tensor(x, "cpu"), to_tensor(y, "cpu")
    mine = (ntt32.fwd_ntt32(xt, plan, 4, 1), ntt32.fwd_ntt32(xt, plan, 4, 4),
            ntt32.inv_ntt32(yt, plan, 2, 1), ntt32.inv_ntt32(yt, plan, 2, 2))
    for name, a, b in zip(("fwd 1", "fwd 4", "inv 1", "inv 2"), mine,
                          theirs):
        np.testing.assert_array_equal(to_numpy(a),
                                      np.asarray(b).astype(np.uint64),
                                      err_msg=name)


def test_single_word_tables_match_jax():
    """precon32 tables and constants against the JAX plan's stage tables
    (plan.py:220-237)."""
    n = 1 << 12
    q = _prime(29, n)
    plan, jp = get_plan(n, q), jax_get_plan(n, q)
    assert plan.inv_n_precon32 == jp.inv_n_precon32
    assert plan.inv_n_w_precon32 == jp.inv_n_w_precon32
    for m, t, w, wp in jp.fwd_a32:
        np.testing.assert_array_equal(np.asarray(wp), plan.prop32[m:2 * m])
    for m, t, w, wp in jp.inv_a32:
        start = torch_ntt.root_index(n, t)
        np.testing.assert_array_equal(np.asarray(wp),
                                      plan.pirop32[start:start + m])
    assert get_plan(n, _prime(30, n)).bit_shift == 64


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def test_plain_walk_vs_pallas_kernel(interpret_pallas):
    """ntt32.py::_run_pallas (the kernel K7 replaces) at N = 2^10, batch 2,
    both directions and both OMFs."""
    n = 1 << 10
    q = _prime(29, n)
    plan, jp = get_plan(n, q), jax_get_plan(n, q)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 4 * q, size=(2, n), dtype=np.uint64)
    y = rng.integers(0, 2 * q, size=(2, n), dtype=np.uint64)
    for omf in (1, 4):
        theirs = jax_ntt32._run_pallas(jnp.asarray(x.astype(np.uint32)), jp,
                                       omf, True)
        np.testing.assert_array_equal(
            to_numpy(ntt32.fwd_ntt32(to_tensor(x, "cpu"), plan, 4, omf)),
            np.asarray(theirs).astype(np.uint64), err_msg=f"fwd {omf}")
    for omf in (1, 2):
        theirs = jax_ntt32._run_pallas(jnp.asarray(y.astype(np.uint32)), jp,
                                       omf, False)
        np.testing.assert_array_equal(
            to_numpy(ntt32.inv_ntt32(to_tensor(y, "cpu"), plan, 2, omf)),
            np.asarray(theirs).astype(np.uint64), err_msg=f"inv {omf}")


def test_public_routing_rule():
    """q < 2^30 with N = 512 stays on the 64-bit walk (the JAX plan has no
    2-D tables there); with N = 1024 `NTT` takes the single-word walk,
    whose lazy outputs differ from the 64-bit walk's."""
    rng = np.random.default_rng(9)
    for n, single in ((512, False), (1024, True)):
        q = _prime(29, n)
        engine = NTT(n, q, device="cpu")
        assert engine.plan.single_word is single
        x = rng.integers(0, 4 * q, size=(2, n), dtype=np.uint64)
        xt = to_tensor(x, "cpu")
        lazy = engine.forward(xt, 4, 4)
        wide = torch_ntt.fwd_ntt(xt, engine.plan, 4, 4)
        narrow = torch_ntt.fwd_ntt(xt, engine.plan, 4, 4, word=32)
        assert torch.equal(lazy, narrow if single else wide)
        np.testing.assert_array_equal(
            to_numpy(lazy), np.asarray(JaxNTT(n, q).forward(x, 4, 4)))
        if single:
            assert not torch.equal(wide, narrow)
        assert torch.equal((wide - narrow) % q, torch.zeros_like(wide))


def test_single_word_wrapper_errors():
    """The wrapper's checks with word=32 (the route of K7)."""
    n = 1 << 10
    plan = get_plan(n, _prime(50, n))
    with pytest.raises(ValueError, match="2\\^30"):
        cuda_ntt.fwd_ntt(torch.zeros(n, dtype=torch.int64), plan, word=32)
    plan32 = get_plan(n, _prime(29, n))
    with pytest.raises(ValueError):
        cuda_ntt.inv_ntt(torch.zeros(n, dtype=torch.int64), plan32, 4, 1,
                         word=32)
    with pytest.raises(ValueError):
        cuda_ntt.fwd_ntt(torch.zeros(n // 2, dtype=torch.int64), plan32,
                         word=32)
