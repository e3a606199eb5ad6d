"""The port's DistNTT on other mesh shapes, its fused product and the RNS
product, against the JAX package on its 8 virtual CPU devices.

The (coeff 4, batch 2) mesh with the leading dim over the batch rows and
with it replicated (batch_shard=False); `poly_mult` and
`dist_rns_poly_mult` (bit for bit, and against the port's single-device
products); and D = 1 at q < 2^30, where the JAX DistNTT runs the 64-bit
walk: the port's lazy outputs must be that walk's, not those of the
single-word transform that the public NTT takes for such a q.
"""

import numpy as np

from hexl_tpu import nt as jnt
from hexl_tpu.parallel import DistNTT as JaxDistNTT
from hexl_tpu.parallel import dist_rns_poly_mult as jax_dist_rns_poly_mult
from hexl_tpu.parallel import make_mesh as jax_make_mesh
from hexl_tpu_torch import NTT, poly_mult_mod, rns_poly_mult_mod
from hexl_tpu_torch.parallel import (DistNTT, dist_rns_poly_mult,
                                     get_dist_ntt, make_mesh)

N = 1 << 12


def cpu_mesh(d, nb=1):
    return make_mesh(d, nb, ["cpu"] * (d * nb))


def test_batch_rows_vs_jax():
    q = jnt.generate_primes(1, 60, True, ntt_size=N)[0]
    mine = DistNTT(N, q, cpu_mesh(4, 2))
    theirs = JaxDistNTT(N, q, jax_make_mesh(4, 2))
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=(4, N), dtype=np.uint64)
    y = mine.forward(x, 1, 4)
    np.testing.assert_array_equal(y, np.asarray(theirs.forward(x, 1, 4)))
    back = mine.inverse(y % np.uint64(q), 1, 1)
    np.testing.assert_array_equal(
        back, np.asarray(theirs.inverse(y % np.uint64(q), 1, 1)))
    np.testing.assert_array_equal(back, x)
    # Replicated leading dims: 3 rows do not divide the 2 batch rows.
    x3 = x[:3]
    np.testing.assert_array_equal(
        mine.forward(x3, 1, 1, batch_shard=False),
        np.asarray(theirs.forward(x3, 1, 1, batch_shard=False)))


def test_poly_mult_vs_jax_and_single_device():
    q = jnt.generate_primes(1, 50, True, ntt_size=N)[0]
    mine = DistNTT(N, q, cpu_mesh(4, 2))
    theirs = JaxDistNTT(N, q, jax_make_mesh(4, 2))
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, q, size=(2, N), dtype=np.uint64)
            for _ in range(2))
    got = mine.poly_mult(a, b)
    np.testing.assert_array_equal(got, np.asarray(theirs.poly_mult(a, b)))
    np.testing.assert_array_equal(got, poly_mult_mod(a, b, N, q,
                                                     device="cpu"))


def test_dist_rns_poly_mult_vs_jax_and_single_device():
    primes = jnt.generate_primes(2, 45, True, ntt_size=N)
    rng = np.random.default_rng(4)
    a = rng.integers(0, min(primes), size=(2, 2, N), dtype=np.uint64)
    b = rng.integers(0, min(primes), size=(2, 2, N), dtype=np.uint64)
    mesh = cpu_mesh(4, 2)
    got = dist_rns_poly_mult(a, b, N, primes, mesh)
    np.testing.assert_array_equal(
        got, np.asarray(jax_dist_rns_poly_mult(a, b, N, primes,
                                               jax_make_mesh(4, 2))))
    np.testing.assert_array_equal(
        got, rns_poly_mult_mod(a, b, N, primes, device="cpu"))
    assert get_dist_ntt(N, primes[0], mesh) is get_dist_ntt(
        N, primes[0], cpu_mesh(4, 2))


def test_single_position_small_modulus_takes_the_64_bit_walk():
    q = jnt.generate_primes(1, 29, True, ntt_size=N)[0]
    mine = DistNTT(N, q, cpu_mesh(1))
    theirs = JaxDistNTT(N, q, jax_make_mesh(1, 1))
    rng = np.random.default_rng(7)
    x = rng.integers(0, 4 * q, size=(2, N), dtype=np.uint64)
    y = mine.forward(x, 4, 4)
    np.testing.assert_array_equal(y, np.asarray(theirs.forward(x, 4, 4)))
    public = NTT(N, q, device="cpu")
    assert public.plan.single_word
    assert not np.array_equal(y, public.forward(x, 4, 4))
    z = x % np.uint64(2 * q)
    np.testing.assert_array_equal(mine.inverse(z, 2, 2),
                                  np.asarray(theirs.inverse(z, 2, 2)))
