"""The approximate-butterfly regime beyond one small transform: lean16 at
N = 2^13 and the RNS engine against the JAX engine forced the same way,
and the two-pass split (N > 2^14) against the NumPy oracle.

RnsNTT picks its scheme from the basis's largest modulus, as the JAX
stacked bodies do (`hexl_tpu/ntt/rns.py:118-177`), so a small prime in a
basis runs the scheme of the large one. Above 2^14 the JAX bodies compile
too long for the tier-1 run: there the port's lean walk (the plain K5/K6
passes) is held against `hexl_tpu.ref` fully reduced, mod q and by range
when lazy, and against its own exact walk.
"""

import numpy as np
import pytest

import hexl_tpu_torch.config as port_config
from hexl_tpu import config as jax_config
from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu.ntt import RnsNTT as JaxRnsNTT
from hexl_tpu_torch import NTT, RnsNTT
from hexl_tpu_torch.ntt import torch_ntt

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setattr(jax_config, "approx_butterflies", lambda: True)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: True)


def test_lean16_at_8192_vs_jax_forced(forced):
    n = 1 << 13
    q = jnt.generate_primes(1, 59, True, ntt_size=n)[0]
    assert torch_ntt.scheme_for(q, n, "cpu") == "lean16"
    mine, theirs = NTT(n, q, device="cpu"), JaxNTT(n, q)
    rng = np.random.default_rng(8192)
    for imf, omf in ((1, 1), (4, 4), (2, 4)):
        x = rng.integers(0, imf * q, size=(2, n), dtype=np.uint64)
        np.testing.assert_array_equal(
            mine.forward(x, imf, omf), np.asarray(theirs.forward(x, imf, omf)),
            err_msg=f"fwd imf={imf} omf={omf}")
    for imf, omf in ((1, 1), (2, 2)):
        x = rng.integers(0, imf * q, size=(2, n), dtype=np.uint64)
        np.testing.assert_array_equal(
            mine.inverse(x, imf, omf), np.asarray(theirs.inverse(x, imf, omf)),
            err_msg=f"inv imf={imf} omf={omf}")


@pytest.mark.parametrize("n,bits", [(1 << 13, (59, 40)), (1024, (60, 30))])
def test_rns_vs_jax_forced(n, bits, forced):
    """The basis's largest modulus picks lean16 (59 bits, N = 2^13) or
    lean8 (60 bits) for every row, the 40- and 30-bit primes included;
    lazy outputs bit-equal to the JAX stacked engine's."""
    moduli = [jnt.generate_primes(1, b, True, ntt_size=n)[0] for b in bits]
    mine, theirs = RnsNTT(n, moduli, device="cpu"), JaxRnsNTT(n, moduli)
    rng = np.random.default_rng(n)
    for forward, imf, omf in ((True, 1, 4), (True, 4, 1), (False, 2, 2),
                              (False, 1, 1)):
        x = np.stack([rng.integers(0, imf * q, size=(2, n), dtype=np.uint64)
                      for q in moduli])
        fn = "forward" if forward else "inverse"
        np.testing.assert_array_equal(
            getattr(mine, fn)(x, imf, omf),
            np.asarray(getattr(theirs, fn)(x, imf, omf)),
            err_msg=f"{fn} imf={imf} omf={omf}")


@pytest.mark.parametrize("n,q_bits,scheme", [(1 << 15, 59, "lean16"),
                                             (1 << 15, 60, "lean8"),
                                             (1 << 17, 49, "lean16")])
def test_split_lean_vs_oracle(n, q_bits, scheme, forced, monkeypatch):
    """The lean split: OMF 1 equal to the oracle and to the exact walk;
    lazy outputs in range and equal mod q; the round trip exact."""
    q = jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    assert torch_ntt.scheme_for(q, n, "cpu") == scheme
    engine = NTT(n, q, device="cpu")
    plan = engine.plan
    rng = np.random.default_rng(q_bits)
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    want = ref.fwd_ntt_radix2(x, q, plan.rop, plan.prop, 1, 1)
    np.testing.assert_array_equal(engine.forward(x, 1, 1), want)
    lazy = engine.forward(x + np.uint64(3 * q), 4, 4)
    assert lazy.max() < 4 * q
    np.testing.assert_array_equal(lazy % np.uint64(q), want)
    back = engine.inverse(want, 1, 2)
    assert back.max() < 2 * q
    np.testing.assert_array_equal(back % np.uint64(q), x)
    np.testing.assert_array_equal(engine.inverse(want, 1, 1), x)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: False)
    assert torch_ntt.scheme_for(q, n, "cpu") == "exact"
    np.testing.assert_array_equal(engine.forward(x, 1, 1), want)
