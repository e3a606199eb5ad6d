"""K3's lean16/lean8 forms on the CPU: the port's `poly_mult_mod` in the
lean schemes against the JAX package's XLA body, bit for bit.

Where `config.approx_butterflies()` is on, `hexl_tpu.poly._poly_mult_xla`
(poly.py:93-97) runs `jnp_ntt`'s lean butterflies (`_bflys3`: lean16 from
`LEAN16_MIN_N` and below 2^60, else lean8) and the approximate `mult_mod`.
The port's `poly_mult_mod` takes the same scheme (`torch_ntt.scheme_for`)
into K3, whose plain chain runs `torch_ntt`'s lean walks and the
approximate `mult_mod`. Held here, with the switch forced on both sides
(and lean16's least degree lowered on both, so that n = 2^6 .. 2^12 runs
each scheme): the public product, the scheme each call took, the plain
chain's forward outputs against `jnp_ntt`'s lazy ones, and its product
against `K.mult_mod`'s approximate one.
"""

import numpy as np
import pytest

import hexl_tpu_torch.config as port_config
from hexl_tpu import config as jax_config
from hexl_tpu import nt as jnt
from hexl_tpu.eltwise import jnp_kernels as JK
from hexl_tpu.limb import from_limbs, to_limbs
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu.ntt import jnp_ntt
from hexl_tpu.poly import poly_mult_mod as jax_poly_mult_mod
from hexl_tpu_torch import get_plan, poly, poly_mult_mod
from hexl_tpu_torch.eltwise import torch_kernels
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import torch_ntt

# (log_n, q_bits, scheme): q_bits as generate_primes takes it, q in
# (2^b, 2^(b+1)); lean16 needs q < 2^60, lean8 q < 2^61.
CASES = [(6, 58, "lean16"), (6, 59, "lean8"), (9, 50, "lean16"),
         (9, 60, "lean8"), (12, 55, "lean16"), (12, 60, "lean8")]


@pytest.fixture
def approx_on(monkeypatch):
    monkeypatch.setattr(jax_config, "approx_butterflies", lambda: True)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: True)


def _modulus(q_bits, n):
    if q_bits == 60:    # the largest prime below 2^61: 8q just under 2^64
        return jnt.generate_primes(1, 60, False, ntt_size=n)[0]
    return jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]


def _lean16_from(monkeypatch, n):
    """lean16 from degree n on, on both sides."""
    monkeypatch.setattr(jnp_ntt, "LEAN16_MIN_N", n)
    monkeypatch.setattr(torch_ntt, "LEAN16_MIN_N", n)


@pytest.mark.parametrize("log_n,q_bits,scheme", CASES)
def test_poly_mult_mod_lean_vs_jax(log_n, q_bits, scheme, approx_on,
                                   monkeypatch):
    n = 1 << log_n
    q = _modulus(q_bits, n)
    _lean16_from(monkeypatch, n if scheme == "lean16" else 2 * n)
    assert torch_ntt.scheme_for(q, n, "cpu") == scheme
    schemes = []
    plain = poly.poly_mult_plain

    def recording(a, b, plan, scheme="exact"):
        schemes.append(scheme)
        return plain(a, b, plan, scheme)

    monkeypatch.setattr(poly, "poly_mult_plain", recording)
    rng = np.random.default_rng(log_n * 100 + q_bits)
    a = rng.integers(0, q, size=(3, n), dtype=np.uint64)
    b = rng.integers(0, q, size=(1, n), dtype=np.uint64)
    got = poly_mult_mod(a, b, n, q, device="cpu")
    assert schemes == [scheme]
    np.testing.assert_array_equal(got,
                                  np.asarray(jax_poly_mult_mod(a, b, n, q)))


@pytest.mark.parametrize("log_n,q_bits,scheme", CASES[:4])
def test_plain_chain_steps_vs_jax(log_n, q_bits, scheme, approx_on,
                                  monkeypatch):
    """The plain chain's lazy forward outputs (OMF 4) against `jnp_ntt`'s
    in the same scheme, and its approximate mult_mod against the JAX
    body's."""
    n = 1 << log_n
    q = _modulus(q_bits, n)
    _lean16_from(monkeypatch, n if scheme == "lean16" else 2 * n)
    plan, jplan = get_plan(n, q), jax_get_plan(n, q)
    rng = np.random.default_rng(log_n + q_bits)
    a = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    fa = torch_ntt.fwd_ntt(to_tensor(a, "cpu"), plan, 1, 4, 64, scheme)
    want = jnp_ntt.fwd_ntt(to_limbs(a), jplan, 1, 4)
    np.testing.assert_array_equal(to_numpy(fa), from_limbs(want))
    b = rng.integers(0, 4 * q, size=(2, n), dtype=np.uint64)
    prod = torch_kernels.mult_mod(fa, to_tensor(b, "cpu"), q, 4, True)
    np.testing.assert_array_equal(
        to_numpy(prod), from_limbs(JK.mult_mod(want, to_limbs(b), q, 4)))


def test_k3_takes_every_scheme():
    """No scheme is mapped to another: the plain chain and K3's wrapper run
    what they are given, and the chain is equal to the exact one."""
    n = 1 << 8
    q = _modulus(58, n)
    plan = get_plan(n, q)
    rng = np.random.default_rng(8)
    a, b = (to_tensor(rng.integers(0, q, size=(2, n), dtype=np.uint64),
                      "cpu") for _ in range(2))
    exact = poly.poly_mult(a, b, plan)
    for scheme in torch_ntt.SCHEMES:
        assert (poly.poly_mult(a, b, plan, scheme) == exact).all()
    assert not hasattr(poly, "k3_scheme")
