"""The port's `NttPlan` constructor against the JAX package's.

`hexl_tpu_torch.ntt.NttPlan(degree, modulus, root=None, device=None)`
constructs as `hexl_tpu.ntt.NttPlan` does: it checks (N, q), takes the
minimal primitive 2N-th root when none is given, refuses a root that is not
primitive, builds the same tables and, with a device, places them there.
"""

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu.ntt import NttPlan as JaxNttPlan
from hexl_tpu_torch import nt
from hexl_tpu_torch.limb import to_numpy
from hexl_tpu_torch.ntt import NttPlan, get_plan
from hexl_tpu_torch.ntt import plan as plan_mod

CASES = [(1, 29), (2, 62), (3, 40), (4, 30), (5, 55), (6, 61), (7, 33),
         (8, 50), (9, 45), (10, 29), (11, 60), (12, 36), (13, 58), (14, 62)]


def _prime(q_bits, n):
    """A prime q = 1 mod 2N of exactly `q_bits` bits."""
    q = jnt.generate_primes(1, q_bits - 1, True, ntt_size=n)[0]
    assert q.bit_length() == q_bits
    return q


def _assert_same(mine, theirs):
    assert mine.root == theirs.root
    for name in ("rop", "prop", "irop", "pirop"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name), err_msg=name)
    assert mine.inv_n == theirs.inv_n


@pytest.mark.parametrize("log_n,q_bits", CASES)
@pytest.mark.parametrize("given_root", [False, True])
def test_constructor_matches_jax(log_n, q_bits, given_root):
    n = 1 << log_n
    q = _prime(q_bits, n)
    root = None
    if given_root:
        # Another primitive 2N-th root: an odd power of the minimal one.
        root = pow(nt.minimal_primitive_root(2 * n, q), 3, q)
    mine, theirs = NttPlan(n, q, root), JaxNttPlan(n, q, root)
    _assert_same(mine, theirs)
    if given_root:
        assert mine.root == root


def test_constructor_python_tables(monkeypatch):
    """Without the host library the Python tables are built, the same."""
    monkeypatch.setenv("HEXL_TPU_DISABLE_NATIVE", "1")
    n, q = 1 << 9, _prime(50, 1 << 9)
    _assert_same(NttPlan(n, q), JaxNttPlan(n, q))


def test_constructor_example_modulus():
    q = jnt.generate_primes(1, 50, True, ntt_size=1024)[0]
    assert q == 1125899906856961
    plan = NttPlan(1024, q)
    assert plan.root == 908210799364 == JaxNttPlan(1024, q).root


def test_invalid_root_rejected():
    """The mirror of the JAX package's test: a caller-supplied root that is
    not primitive raises."""
    n = 64
    q = nt.generate_primes(1, 30, True, ntt_size=n)[0]
    with pytest.raises(ValueError, match="primitive"):
        NttPlan(n, q, root=5 if not nt.is_primitive_root(5, 2 * n, q)
                else 7)


@pytest.mark.parametrize("degree,modulus", [(3, 7), (64, 97), (64, 1 << 63)])
def test_invalid_arguments_rejected(degree, modulus):
    with pytest.raises(ValueError):
        JaxNttPlan(degree, modulus)
    with pytest.raises(ValueError):
        NttPlan(degree, modulus)


def test_device_places_tables():
    n, q = 1 << 8, _prime(40, 1 << 8)
    plan = NttPlan(n, q, device="cpu")
    assert "cpu" in plan._dev
    tabs = plan.tables("cpu")
    for name in ("rop", "prop", "irop", "pirop"):
        assert tabs[name].device == torch.device("cpu")
        np.testing.assert_array_equal(to_numpy(tabs[name]),
                                      getattr(plan, name))


def test_from_tables_and_build_agree():
    n, q = 1 << 10, _prime(60, 1 << 10)
    built = NttPlan.build(n, q)
    carried = NttPlan.from_tables(n, q, built.root, built.rop, built.prop,
                                  built.irop, built.pirop)
    _assert_same(carried, built)
    for name in ("inv_n_precon", "inv_n_w", "inv_n_w_precon"):
        assert getattr(carried, name) == getattr(built, name)
    plan_mod.clear_plan_cache()
    _assert_same(get_plan(n, q), built)
