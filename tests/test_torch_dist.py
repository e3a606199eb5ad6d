"""The port's DistNTT on meshes of "cpu" positions against the JAX package.

`hexl_tpu.parallel.DistNTT` runs on the 8 virtual CPU devices of
tests/conftest.py, where its bodies are the exact Harvey butterflies, so
every output is held bit for bit, lazy ones included: D in {2, 4, 8} over
the IMF/OMF matrix, the per-shard and cross twiddle tables, the argument
errors, the overlap slices (the port against itself), and the per-shard
walks of L = 2^15 (N = 2^16, D = 2) against the port's single-device NTT
and the NumPy oracle `hexl_tpu.ref`. The JAX transform reads the IMF only
as the input's range, so it is called at the widest IMF of its direction
(one compile per OMF). The mesh shapes, batch_shard, the fused product,
the RNS product and D = 1 are in test_torch_dist_mesh.py; the Pallas
local kernel in test_torch_dist_pallas.py.
"""

import numpy as np
import pytest

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.limb import from_limbs
from hexl_tpu.parallel import DistNTT as JaxDistNTT
from hexl_tpu.parallel import make_mesh as jax_make_mesh
from hexl_tpu_torch import NTT, poly_mult_mod
from hexl_tpu_torch.ntt import torch_ntt
from hexl_tpu_torch.parallel import DistNTT, make_mesh
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 1 << 12


def cpu_mesh(d, nb=1):
    return make_mesh(d, nb, ["cpu"] * (d * nb))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_forward_inverse_vs_jax(d):
    q = jnt.generate_primes(1, 50, True, ntt_size=N)[0]
    mine, theirs = DistNTT(N, q, cpu_mesh(d)), JaxDistNTT(
        N, q, jax_make_mesh(d, 1))
    rng = np.random.default_rng(d)
    for omf in (1, 4):
        for imf in (1, 2, 4):
            x = rng.integers(0, imf * q, size=(2, N), dtype=np.uint64)
            np.testing.assert_array_equal(
                mine.forward(x, imf, omf),
                np.asarray(theirs.forward(x, 4, omf)),
                err_msg=f"fwd imf={imf} omf={omf}")
    for omf in (1, 2):
        for imf in (1, 2):
            x = rng.integers(0, imf * q, size=(2, N), dtype=np.uint64)
            np.testing.assert_array_equal(
                mine.inverse(x, imf, omf),
                np.asarray(theirs.inverse(x, 2, omf)),
                err_msg=f"inv imf={imf} omf={omf}")


@pytest.mark.parametrize("d", [2, 4, 8])
def test_tables_equal_jax(d):
    """The plan tables, every shard's stage twiddles of stride >= 128 (the
    JAX per-device tables' row-axis stages) and the cross tables."""
    n = 1 << 14
    q = jnt.generate_primes(1, 60, True, ntt_size=n)[0]
    mine, theirs = DistNTT(n, q, cpu_mesh(d)), JaxDistNTT(
        n, q, jax_make_mesh(d, 1))
    p = mine.plan
    for name in ("rop", "prop", "irop", "pirop"):
        np.testing.assert_array_equal(getattr(p, name),
                                      getattr(theirs.plan, name))
    for r in range(d):
        for m, t, w, wp in theirs.fwd_a:
            at = torch_ntt.fwd_index(m, r, d)
            np.testing.assert_array_equal(from_limbs(w)[r], p.rop[at:at + m])
            np.testing.assert_array_equal(from_limbs(wp)[r],
                                          p.prop[at:at + m])
        for m, t, w, wp in theirs.inv_a:
            at = torch_ntt.inv_index(n, m, r, d)
            np.testing.assert_array_equal(from_limbs(w)[r], p.irop[at:at + m])
            np.testing.assert_array_equal(from_limbs(wp)[r],
                                          p.pirop[at:at + m])
    for m, w, wp in theirs.cross_fwd:
        np.testing.assert_array_equal(from_limbs(w), p.rop[m:2 * m])
        np.testing.assert_array_equal(from_limbs(wp), p.prop[m:2 * m])
    for m, w, wp in theirs.cross_inv:
        at = torch_ntt.inv_index(n, m)
        np.testing.assert_array_equal(from_limbs(w), p.irop[at:at + m])
        np.testing.assert_array_equal(from_limbs(wp), p.pirop[at:at + m])


@pytest.mark.parametrize("n,d,match", [(32, 8, "D\\^2"),
                                       (256, 2, "too small")])
def test_same_errors_as_jax(n, d, match):
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    with pytest.raises(ValueError, match=match):
        JaxDistNTT(n, q, jax_make_mesh(d, 1))
    with pytest.raises(ValueError, match=match):
        DistNTT(n, q, cpu_mesh(d))


@pytest.mark.parametrize("slices", [2, 4])
def test_overlap_slices_equal_one_exchange(slices):
    n = 1 << 13
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    mesh = cpu_mesh(4, 2)
    rng = np.random.default_rng(17)
    x = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    blocking = DistNTT(n, q, mesh, overlap_slices=1)
    overlapped = DistNTT(n, q, mesh, overlap_slices=slices)
    assert overlapped._slice_count(n // 16) == slices
    for fn, omf in (("forward", 4), ("inverse", 2), ("forward", 1)):
        np.testing.assert_array_equal(getattr(blocking, fn)(x, 1, omf),
                                      getattr(overlapped, fn)(x, 1, omf))
    np.testing.assert_array_equal(blocking.poly_mult(x, x),
                                  overlapped.poly_mult(x, x))


def test_overlap_slices_read_the_environment(monkeypatch):
    q = jnt.generate_primes(1, 50, True, ntt_size=N)[0]
    monkeypatch.setenv("HEXL_TPU_DIST_OVERLAP", "3")
    assert DistNTT(N, q, cpu_mesh(2)).overlap_slices == 3
    monkeypatch.setenv("HEXL_TPU_DIST_OVERLAP", "x")
    with pytest.raises(ValueError, match="HEXL_TPU_DIST_OVERLAP"):
        DistNTT(N, q, cpu_mesh(2))


def test_large_shards_vs_single_device_and_oracle():
    """L = 2^15 (N = 2^16, D = 2): the shard walks over 2^15 coefficients,
    forward and inverse at every OMF, against NTT and the NumPy oracle."""
    n = 1 << 16
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    mine, single = DistNTT(n, q, cpu_mesh(2)), NTT(n, q, device="cpu")
    p = mine.plan
    rng = np.random.default_rng(16)
    x = rng.integers(0, 4 * q, size=(1, n), dtype=np.uint64)
    for omf in (1, 4):
        got = mine.forward(x, 4, omf)
        np.testing.assert_array_equal(got, single.forward(x, 4, omf))
        np.testing.assert_array_equal(
            got[0], ref.fwd_ntt_radix2(x[0], q, p.rop, p.prop, 4, omf))
    y = x % np.uint64(2 * q)
    for omf in (1, 2):
        got = mine.inverse(y, 2, omf)
        np.testing.assert_array_equal(got, single.inverse(y, 2, omf))
        np.testing.assert_array_equal(
            got[0], ref.inv_ntt_radix2(y[0], q, p.irop, p.pirop, 2, omf))


def test_many_positions_vs_single_device_and_oracle():
    """D = 128 (N = 2^15, L = 256), more coefficient positions than the
    8 devices of the JAX tests: forward and inverse at every OMF and the
    product, against NTT and the NumPy oracle. On the card its cross pass
    is K5's two-launch form (more than 64 rows)."""
    n, d = 1 << 15, 128
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    mine, single = DistNTT(n, q, cpu_mesh(d)), NTT(n, q, device="cpu")
    p = mine.plan
    rng = np.random.default_rng(d)
    x = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    for omf in (1, 4):
        got = mine.forward(x, 1, omf)
        np.testing.assert_array_equal(got, single.forward(x, 1, omf))
        np.testing.assert_array_equal(
            got[1], ref.fwd_ntt_radix2(x[1], q, p.rop, p.prop, 1, omf))
    for omf in (1, 2):
        got = mine.inverse(x, 1, omf)
        np.testing.assert_array_equal(got, single.inverse(x, 1, omf))
        np.testing.assert_array_equal(
            got[0], ref.inv_ntt_radix2(x[0], q, p.irop, p.pirop, 1, omf))
    np.testing.assert_array_equal(mine.poly_mult(x, x),
                                  poly_mult_mod(x, x, n, q, device="cpu"))
