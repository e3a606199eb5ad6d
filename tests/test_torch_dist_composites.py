"""The port's sharded composites on meshes of "cpu" positions against the
JAX package's (`hexl_tpu.parallel.dist_dyadic_multiply`,
`dist_key_switch`, on its 8 virtual CPU devices) and against the port's
single-device composites, bit for bit, at tests/test_dist_ntt.py's shapes.
"""

import numpy as np

from hexl_tpu import nt as jnt
from hexl_tpu.parallel import dist_dyadic_multiply as jax_dist_dyadic
from hexl_tpu.parallel import dist_key_switch as jax_dist_key_switch
from hexl_tpu.parallel import make_mesh as jax_make_mesh
from hexl_tpu_torch import dyadic_multiply, key_switch
from hexl_tpu_torch.parallel import (dist_dyadic_multiply, dist_key_switch,
                                     make_mesh)


def test_dist_dyadic_multiply():
    n, m = 1024, 4
    moduli = jnt.generate_primes(m, 40, True, ntt_size=n)
    rng = np.random.default_rng(11)
    x, y = (np.stack([np.stack([rng.integers(0, q, n, np.uint64)
                                for q in moduli]) for _ in range(2)])
            for _ in range(2))
    want = dyadic_multiply(x, y, moduli, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(jax_dist_dyadic(x, y, moduli, jax_make_mesh(4, 2))), want)
    # The modulus axis over the batch rows (4 moduli, 2 rows), and
    # replicated where the rows do not divide it (3 rows).
    for d, nb in ((4, 2), (2, 3), (1, 1)):
        got = dist_dyadic_multiply(x, y, moduli,
                                   make_mesh(d, nb, ["cpu"] * (d * nb)))
        np.testing.assert_array_equal(got, want)


def test_dist_key_switch():
    n, ds, kc = 1024, 2, 2
    kms = rns = ds + 1
    moduli = jnt.generate_primes(kms, 40, True, ntt_size=n)
    qk = moduli[-1]
    rng = np.random.default_rng(12)
    t_target = np.stack([rng.integers(0, q, n, np.uint64)
                         for q in moduli[:ds]])
    keys = rng.integers(0, min(moduli), size=(ds, kc, kms, n),
                        dtype=np.uint64)
    for j in range(ds):
        for k in range(kc):
            for m_i, q in enumerate(moduli):
                keys[j, k, m_i] %= np.uint64(q)
    msf = [jnt.inverse_mod(qk % q, q) for q in moduli[:ds]]
    result = np.stack([np.stack([rng.integers(0, q, n, np.uint64)
                                 for q in moduli[:ds]])
                       for _ in range(kc)])
    args = (result, t_target, n, ds, kms, rns, kc, moduli, keys, msf)
    got = dist_key_switch(*args, make_mesh(2, 4, ["cpu"] * 8))
    np.testing.assert_array_equal(got, key_switch(*args, device="cpu"))
    np.testing.assert_array_equal(
        got, np.asarray(jax_dist_key_switch(*args, jax_make_mesh(2, 4))))
    np.testing.assert_array_equal(
        dist_key_switch(*args, make_mesh(4, 1, ["cpu"] * 4)), got)
