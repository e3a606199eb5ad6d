"""The approximate-butterfly regime (lean16/lean8) of the port's plain NTT
against the JAX engine with its approximation forced on.

On the CPU both packages run exact butterflies by default. Forcing
`hexl_tpu.config.approx_butterflies` (the JAX engine's device bodies,
`jnp_ntt._bflys3`) and `hexl_tpu_torch.config.approx_butterflies` (the
port's `torch_ntt.scheme_for`) selects the same scheme for the same
(q, N), and the two walks agree bit for bit, lazy outputs included, over
the IMF/OMF matrix. generate_primes(1, b) gives q in (2^b, 2^(b+1)): 59
bits runs lean16 at N >= 2^13 (lean8 below), 60 bits lean8, 61 bits the
exact forms. The JAX transforms compile once per (IMF, OMF), so the file
keeps to the sizes named here.
"""

import numpy as np
import pytest
import torch

import hexl_tpu_torch.config as port_config
from hexl_tpu import config as jax_config
from hexl_tpu import nt as jnt
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu.ntt import jnp_ntt
from hexl_tpu_torch import NTT
from hexl_tpu_torch.ntt import cuda_ntt, get_plan, torch_ntt


@pytest.fixture
def forced(monkeypatch):
    """Approximation on in both packages, as the JAX tests force it."""
    monkeypatch.setattr(jax_config, "approx_butterflies", lambda: True)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: True)


def _matrix(mine, theirs, q, n, rng, batch=2):
    for imf in (1, 2, 4):
        x = rng.integers(0, imf * q, size=(batch, n), dtype=np.uint64)
        for omf in (1, 4):
            np.testing.assert_array_equal(
                mine.forward(x, imf, omf),
                np.asarray(theirs.forward(x, imf, omf)),
                err_msg=f"fwd imf={imf} omf={omf}")
    for imf in (1, 2):
        x = rng.integers(0, imf * q, size=(batch, n), dtype=np.uint64)
        for omf in (1, 2):
            np.testing.assert_array_equal(
                mine.inverse(x, imf, omf),
                np.asarray(theirs.inverse(x, imf, omf)),
                err_msg=f"inv imf={imf} omf={omf}")


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("q_bits", [59, 60, 61])
def test_lean_ntt_vs_jax_forced(n, q_bits, forced):
    q = jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    want = {59: "lean8", 60: "lean8", 61: "exact"}[q_bits]
    assert torch_ntt.scheme_for(q, n, "cpu") == want
    _matrix(NTT(n, q, device="cpu"), JaxNTT(n, q), q, n,
            np.random.default_rng(n + q_bits))


@pytest.mark.parametrize("q_bits,want_big,want_small",
                         [(49, "lean16", "lean8"), (59, "lean16", "lean8"),
                          (60, "lean8", "lean8"), (61, "exact", "exact")])
def test_scheme_selection(q_bits, want_big, want_small, monkeypatch):
    """`test_bflys3_scheme_selection` (tests/test_ntt.py) for the port: the
    scheme map at N = 2^13 and 2^12 equals the JAX engine's, and every
    transform is exact with approximation off."""
    monkeypatch.setattr(jax_config, "approx_butterflies", lambda: True)
    for n, want in ((torch_ntt.LEAN16_MIN_N, want_big),
                    (torch_ntt.LEAN16_MIN_N // 2, want_small)):
        q = jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]
        assert (1 << q_bits) < q < (1 << (q_bits + 1))
        assert torch_ntt.scheme_gates(q, n) == jnp_ntt.scheme_gates(q, n)
        assert torch_ntt.scheme_of(*torch_ntt.scheme_gates(q, n)) == want
        assert jnp_ntt._bflys3(*jnp_ntt.scheme_gates(q, n))[2] == want
        monkeypatch.setattr(port_config, "approx_butterflies",
                            lambda device: True)
        assert torch_ntt.scheme_for(q, n, "cpu") == want
        monkeypatch.setattr(port_config, "approx_butterflies",
                            lambda device: False)
        assert torch_ntt.scheme_for(q, n, "cpu") == "exact"
    assert (torch_ntt.LEAN_APPROX_MAX_Q, torch_ntt.LEAN16_MAX_Q,
            torch_ntt.LEAN16_MIN_N) == (jnp_ntt.LEAN_APPROX_MAX_Q,
                                        jnp_ntt.LEAN16_MAX_Q,
                                        jnp_ntt.LEAN16_MIN_N)


def test_approx_default_and_kill_switch(monkeypatch):
    """Exact on the CPU whatever the switch; HEXL_TPU_DISABLE_APPROX makes
    every device exact; on CUDA the default is the measured one."""
    monkeypatch.delenv("HEXL_TPU_DISABLE_APPROX", raising=False)
    assert not port_config.approx_butterflies("cpu")
    assert port_config.approx_butterflies("cuda") == \
        port_config.CUDA_APPROX_DEFAULT
    monkeypatch.setattr(port_config, "CUDA_APPROX_DEFAULT", True)
    assert port_config.approx_butterflies("cuda")
    assert not port_config.approx_butterflies("cpu")
    monkeypatch.setenv("HEXL_TPU_DISABLE_APPROX", "1")
    assert port_config.approx_mulhi_disabled()
    assert not port_config.approx_butterflies("cuda")
    assert not port_config.approx_butterflies("cpu")


def test_lean_scheme_refuses_what_it_cannot_hold():
    """lean16 needs q < 2^60, lean8 q < 2^61, and the single word has no
    lean form: the walks and the wrappers refuse rather than overflow."""
    n = 64
    q61 = jnt.generate_primes(1, 61, True, ntt_size=n)[0]
    q60 = jnt.generate_primes(1, 60, True, ntt_size=n)[0]
    q29 = jnt.generate_primes(1, 29, True, ntt_size=n)[0]
    x = torch.zeros((1, n), dtype=torch.int64)
    for q, scheme, word in ((q61, "lean8", 64), (q60, "lean16", 64),
                            (q29, "lean8", 32), (q60, "lean4", 64)):
        with pytest.raises(ValueError):
            cuda_ntt.fwd_ntt(x, get_plan(n, q), 1, 1, word, scheme)
        with pytest.raises(ValueError):
            torch_ntt.inv_ntt(x, get_plan(n, q), 1, 1, word, scheme)
