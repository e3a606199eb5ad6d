"""The port's SEAL-shim composites (plain versions, CPU) against hexl_tpu's.

`dyadic_multiply` over moduli of mixed bit lengths (which the JAX package
groups by bit length, and the port runs in one stack with per-row
constants), `lr_mat_vec_mult` over four weights, and `key_switch` at
(n=64, ds 2), (2^10, ds 3: the JAX stacked path), (2^9, moduli of 40, 41
and 45 bits: its per-row path) and (2^15, ds 2: through the two-pass
split), each against the JAX function on the same numpy inputs from a
seed, bit for bit, with the caller's `result` left unchanged. Every output
is fully reduced, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu.experimental import dyadic_multiply as jax_dyadic_multiply
from hexl_tpu.experimental import key_switch as jax_key_switch
from hexl_tpu.experimental import lr_mat_vec_mult as jax_lr_mat_vec_mult
from hexl_tpu_torch import dyadic_multiply, key_switch, lr_mat_vec_mult
from hexl_tpu_torch.limb import to_numpy, to_tensor
from tests.torch_threads import one_torch_thread  # noqa: F401


def _moduli(n, bits):
    out = []
    for b in bits:
        out.append(next(q for q in jnt.generate_primes(4, b, True,
                                                       ntt_size=n)
                        if q not in out))
    return out


def _residues(rng, moduli, n, lead=()):
    return np.stack([rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
                     for q in moduli], axis=len(lead))


def test_dyadic_multiply_vs_jax():
    n = 1024
    moduli = _moduli(n, (30, 45, 61))
    rng = np.random.default_rng(0)
    x, y = (_residues(rng, moduli, n, (2,)) for _ in range(2))
    got = dyadic_multiply(x, y, moduli, device="cpu")
    assert got.shape == (3, 3, n)
    np.testing.assert_array_equal(
        got, np.asarray(jax_dyadic_multiply(x, y, moduli)))
    tensor = dyadic_multiply(to_tensor(x, "cpu"), to_tensor(y, "cpu"),
                             moduli)
    assert isinstance(tensor, torch.Tensor)
    np.testing.assert_array_equal(to_numpy(tensor), got)


def test_lr_mat_vec_mult_vs_jax():
    n, weights = 512, 4
    moduli = _moduli(n, (30, 50))
    rng = np.random.default_rng(1)
    c1, c2 = (np.stack([_residues(rng, moduli, n, (2,))
                        for _ in range(weights)]) for _ in range(2))
    got = lr_mat_vec_mult(c1, c2, moduli, device="cpu")
    assert got.shape == (3, 2, n)
    np.testing.assert_array_equal(
        got, np.asarray(jax_lr_mat_vec_mult(c1, c2, moduli)))


@pytest.mark.parametrize("n,ds,kc,bits", [
    (64, 2, 2, (40,) * 3),
    (1 << 10, 3, 2, (49,) * 4),
    (1 << 9, 2, 2, (40, 41, 45)),
    (1 << 15, 2, 2, (49,) * 3),
])
def test_key_switch_vs_jax(n, ds, kc, bits):
    kms = ds + 1
    moduli = _moduli(n, bits)
    qk = moduli[-1]
    rng = np.random.default_rng(n + ds)
    t_target = _residues(rng, moduli[:ds], n)
    keys = np.stack([np.stack([_residues(rng, moduli, n)
                               for _ in range(kc)]) for _ in range(ds)])
    msf = [jnt.inverse_mod(qk % q, q) for q in moduli[:ds]]
    result = np.stack([_residues(rng, moduli[:ds], n) for _ in range(kc)])
    before = result.copy()
    got = key_switch(result, t_target, n, ds, kms, kms, kc, moduli, keys,
                     msf, device="cpu")
    want = np.asarray(jax_key_switch(result, t_target, n, ds, kms, kms, kc,
                                     moduli, keys, msf))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(result, before)


def test_key_switch_arguments():
    n = 64
    moduli = _moduli(n, (40,) * 3)
    z = np.zeros((2, 2, n), dtype=np.uint64)
    keys = np.zeros((2, 2, 3, n), dtype=np.uint64)
    with pytest.raises(ValueError, match="rns_modulus_size"):
        key_switch(z, z[0], n, 2, 3, 2, 2, moduli, keys, [1, 1],
                   device="cpu")
    with pytest.raises(ValueError, match="t_target"):
        key_switch(z, z, n, 2, 3, 3, 2, moduli, keys, [1, 1], device="cpu")
    with pytest.raises(ValueError, match="moduli"):
        dyadic_multiply(z, z, [moduli[0], 1 << 62], device="cpu")
