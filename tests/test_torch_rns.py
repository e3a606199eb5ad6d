"""The port's RNS transform and products (plain versions, CPU) against JAX.

`RnsNTT` row i against the 64-bit single-modulus transform, lazy outputs
included, with a basis that holds a 29-bit prime (which the stacked path
never runs single-word, rns.py:13-16), and against the JAX `RnsNTT` at
2^12; `rns_poly_mult_mod` against `hexl_tpu.poly.rns_poly_mult_mod` at
N = 2^15 x 4 primes and against the oracle product at 2^17 x 2 primes;
`poly_mult_mod` at 2^15 against `hexl_tpu.poly.poly_mult_mod`. Products are
fully reduced, so every comparison is bit for bit.
"""

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.ntt import RnsNTT as JaxRnsNTT
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu.poly import poly_mult_mod as jax_poly_mult_mod
from hexl_tpu.poly import rns_poly_mult_mod as jax_rns_poly_mult_mod
from hexl_tpu_torch import RnsNTT, get_plan, poly_mult_mod, rns_poly_mult_mod
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import torch_ntt
from tests.torch_threads import one_torch_thread  # noqa: F401


def _basis(n, bits):
    return [jnt.generate_primes(1, b, True, ntt_size=n)[0] for b in bits]


def _residues(rng, moduli, n, batch, factor=1):
    return np.stack([rng.integers(0, factor * q, size=(batch, n),
                                  dtype=np.uint64) for q in moduli])


@pytest.mark.parametrize("log_n", [12, 15])
def test_rns_rows_equal_64bit_single_modulus(log_n):
    n = 1 << log_n
    moduli = _basis(n, (29, 50, 60))
    rns = RnsNTT(n, moduli, device="cpu")
    rng = np.random.default_rng(log_n)
    x = _residues(rng, moduli, n, 2, 4)
    for omf in (1, 4):
        got = rns.forward(x, 4, omf)
        for i, q in enumerate(moduli):
            want = torch_ntt.fwd_ntt(to_tensor(x[i], "cpu"), get_plan(n, q),
                                     4, omf)
            np.testing.assert_array_equal(got[i], to_numpy(want),
                                          err_msg=f"fwd row {i} omf {omf}")
    y = _residues(rng, moduli, n, 2, 2)
    for omf in (1, 2):
        got = rns.inverse(y, 2, omf)
        for i, q in enumerate(moduli):
            want = torch_ntt.inv_ntt(to_tensor(y[i], "cpu"), get_plan(n, q),
                                     2, omf)
            np.testing.assert_array_equal(got[i], to_numpy(want),
                                          err_msg=f"inv row {i} omf {omf}")
    if log_n == 12:
        theirs = JaxRnsNTT(n, moduli)
        np.testing.assert_array_equal(rns.forward(x, 4, 4),
                                      np.asarray(theirs.forward(x, 4, 4)))
        np.testing.assert_array_equal(rns.inverse(y, 2, 2),
                                      np.asarray(theirs.inverse(y, 2, 2)))


def test_rns_poly_mult_vs_jax():
    n = 1 << 15
    moduli = _basis(n, (29, 40, 50, 60))
    rng = np.random.default_rng(3)
    a, b = (_residues(rng, moduli, n, 1) for _ in range(2))
    np.testing.assert_array_equal(
        rns_poly_mult_mod(a, b, n, moduli, device="cpu"),
        np.asarray(jax_rns_poly_mult_mod(a, b, n, moduli)))


def test_rns_poly_mult_2e17_vs_oracle():
    """The per-prime pipeline at N = 2^17 (BASELINE.json's RNS row, cut to
    two primes), against the oracle product as test_ntt_large.py builds
    it; tensors in, a tensor out."""
    n = 1 << 17
    moduli = _basis(n, (50, 60))
    rng = np.random.default_rng(5)
    a, b = (_residues(rng, moduli, n, 1)[:, 0] for _ in range(2))
    got = rns_poly_mult_mod(to_tensor(a, "cpu"), to_tensor(b, "cpu"), n,
                            moduli)
    assert isinstance(got, torch.Tensor) and got.shape == (2, n)
    for i, q in enumerate(moduli):
        jp = jax_get_plan(n, q)
        fa = ref.fwd_ntt_radix2(a[i], q, jp.rop, jp.prop, 1, 1)
        fb = ref.fwd_ntt_radix2(b[i], q, jp.rop, jp.prop, 1, 1)
        prod = (fa.astype(object) * fb.astype(object) % q).astype(np.uint64)
        np.testing.assert_array_equal(
            to_numpy(got[i]), ref.inv_ntt_radix2(prod, q, jp.irop, jp.pirop,
                                                 1, 1), err_msg=f"prime {i}")


def test_poly_mult_2e15_vs_jax():
    n = 1 << 15
    q = _basis(n, (50,))[0]
    rng = np.random.default_rng(11)
    a, b = (rng.integers(0, q, size=(2, n), dtype=np.uint64)
            for _ in range(2))
    np.testing.assert_array_equal(poly_mult_mod(a, b, n, q, device="cpu"),
                                  np.asarray(jax_poly_mult_mod(a, b, n, q)))


def test_rns_errors():
    n = 64
    moduli = _basis(n, (40, 50))
    with pytest.raises(ValueError, match="distinct"):
        RnsNTT(n, [moduli[0]] * 2, device="cpu")
    rns = RnsNTT(n, moduli, device="cpu")
    with pytest.raises(ValueError, match="basis axis"):
        rns.forward(np.zeros((3, n), dtype=np.uint64))
    with pytest.raises(ValueError):
        rns_poly_mult_mod(np.zeros((2, n), np.uint64),
                          np.zeros((3, n), np.uint64), n, moduli,
                          device="cpu")
