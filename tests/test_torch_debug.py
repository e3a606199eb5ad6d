"""Debug mode (HEXL_TPU_DEBUG=1) in the port's NTT and RnsNTT, and the
readers of `hexl_tpu_torch.config`, against the JAX package's.

Under debug mode the JAX engines check every input below IMF x q before
transforming (`hexl_tpu/ntt/__init__.py:94-98`, `hexl_tpu/ntt/rns.py:
257-263`); the port raises the same ValueError, with the same message, on
the same inputs (`tests/test_utils.py:43-50` and an RNS case).
"""

import numpy as np
import pytest

import hexl_tpu_torch.config as port_config
from hexl_tpu import config as jax_config
from hexl_tpu import nt as jnt
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu.ntt import RnsNTT as JaxRnsNTT
from hexl_tpu_torch import NTT, RnsNTT
from hexl_tpu_torch.utils import check


@pytest.fixture
def debug_mode(monkeypatch):
    monkeypatch.setenv("HEXL_TPU_DEBUG", "1")


def _message(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


def test_ntt_input_bounds(debug_mode):
    n = 64
    q = jnt.generate_primes(1, 30, True, ntt_size=n)[0]
    mine, theirs = NTT(n, q, device="cpu"), JaxNTT(n, q)
    bad = np.full(n, 2 * q, dtype=np.uint64)
    got = _message(lambda: mine.forward(bad, 1, 1))
    assert got.startswith("forward NTT input: max value")
    assert got == _message(lambda: theirs.forward(bad, 1, 1))
    mine.forward(bad, 4, 1)  # fine at IMF=4
    got = _message(lambda: mine.inverse(bad, 1, 1))
    assert got.startswith("inverse NTT input")
    assert got == _message(lambda: theirs.inverse(bad, 1, 1))
    np.testing.assert_array_equal(mine.inverse(bad - np.uint64(1), 2, 1),
                                  np.asarray(theirs.inverse(
                                      bad - np.uint64(1), 2, 1)))


def test_ntt_tensor_input_checked(debug_mode):
    import torch
    from hexl_tpu_torch.limb import to_tensor
    n = 64
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    x = to_tensor(np.full((2, n), 4 * q, dtype=np.uint64), "cpu")
    with pytest.raises(ValueError, match="forward NTT input"):
        NTT(n, q, device="cpu").forward(x, 4, 4)
    assert isinstance(NTT(n, q, device="cpu").forward(x - 1, 4, 4),
                      torch.Tensor)


def test_rns_input_bounds(debug_mode):
    n = 1024
    moduli = jnt.generate_primes(2, 40, True, ntt_size=n)
    mine, theirs = RnsNTT(n, moduli, device="cpu"), JaxRnsNTT(n, moduli)
    bad = np.stack([np.full(n, 2 * q, dtype=np.uint64) for q in moduli])
    got = _message(lambda: mine.forward(bad, 1, 1))
    assert got.startswith("forward RNS NTT input (prime 0): max value")
    assert got == _message(lambda: theirs.forward(bad, 1, 1))
    mine.forward(bad, 4, 1)
    # Row 1 alone too large: the message names prime 1.
    half = np.stack([np.zeros(n, dtype=np.uint64), bad[1]])
    got = _message(lambda: mine.inverse(half, 2, 1))
    assert got.startswith("inverse RNS NTT input (prime 1)")
    assert got == _message(lambda: theirs.inverse(half, 2, 1))


def test_no_checks_without_debug(monkeypatch):
    monkeypatch.delenv("HEXL_TPU_DEBUG", raising=False)
    n = 64
    q = jnt.generate_primes(1, 30, True, ntt_size=n)[0]
    bad = np.full(n, 2 * q, dtype=np.uint64)
    NTT(n, q, device="cpu").forward(bad, 1, 1)
    RnsNTT(n, [q], device="cpu").forward(bad[None], 1, 1)


@pytest.mark.parametrize("value,on", [("1", True), ("true", True),
                                      ("0", False), ("", False),
                                      ("False", False)])
def test_debug_reader(value, on, monkeypatch):
    monkeypatch.setenv("HEXL_TPU_DEBUG", value)
    assert port_config.debug_checks() is on
    assert check.debug_enabled() is on
    assert jax_config.debug_checks() is on


def test_dist_overlap_reader(monkeypatch):
    """`tests/test_utils.py:175-177` for the port's reader."""
    monkeypatch.delenv("HEXL_TPU_DIST_OVERLAP", raising=False)
    assert port_config.dist_overlap_slices() == 0
    monkeypatch.setenv("HEXL_TPU_DIST_OVERLAP", "4")
    assert port_config.dist_overlap_slices() == 4
    monkeypatch.setenv("HEXL_TPU_DIST_OVERLAP", "two")
    with pytest.raises(ValueError, match="HEXL_TPU_DIST_OVERLAP"):
        port_config.dist_overlap_slices()
    with pytest.raises(ValueError):
        jax_config.dist_overlap_slices()


def test_disable_approx_reader(monkeypatch):
    monkeypatch.setenv("HEXL_TPU_DISABLE_APPROX", "1")
    assert port_config.approx_mulhi_disabled()
    assert jax_config.approx_mulhi_disabled()
    monkeypatch.setenv("HEXL_TPU_DISABLE_APPROX", "0")
    assert not port_config.approx_mulhi_disabled()
