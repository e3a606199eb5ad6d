"""The port's eltwise mult_mod and poly-mult (CPU) against the JAX package.

`eltwise_mult_mod` against `hexl_tpu.eltwise.eltwise_mult_mod`,
`poly_mult_mod` against `hexl_tpu.poly.poly_mult_mod`, and the
`__graft_entry__.entry()` pipeline (fwd OMF 4 -> mult_mod IMF 4 -> inv at
N=2^12, 50-bit, batch 2) against the JAX step function. All outputs are
fully reduced, so every comparison is bit for bit.
"""

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.eltwise import eltwise_mult_mod as jax_eltwise_mult_mod
from hexl_tpu.limb import from_limbs
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu.poly import poly_mult_mod as jax_poly_mult_mod
from hexl_tpu_torch import NTT, eltwise_mult_mod, poly_mult_mod
from hexl_tpu_torch.limb import to_numpy, to_tensor
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("imf", [1, 2, 4])
@pytest.mark.parametrize("q_bits", [30, 50, 60])
def test_eltwise_mult_mod_vs_jax(imf, q_bits):
    q = jnt.generate_primes(1, q_bits, True, ntt_size=1 << 10)[0]
    rng = np.random.default_rng(imf * 100 + q_bits)
    a = rng.integers(0, imf * q, size=(3, 700), dtype=np.uint64)
    b = rng.integers(0, imf * q, size=(3, 700), dtype=np.uint64)
    a[0, :3] = [0, imf * q - 1, q]
    b[0, :3] = [imf * q - 1, imf * q - 1, q - 1]
    got = eltwise_mult_mod(a, b, q, imf, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(
        jax_eltwise_mult_mod(a, b, q, imf)))
    np.testing.assert_array_equal(
        got, ((a.astype(object) * b.astype(object)) % q).astype(np.uint64))


def test_eltwise_operands_and_errors():
    q = jnt.generate_primes(1, 60, True)[0]
    rng = np.random.default_rng(3)
    a = rng.integers(0, q, size=64, dtype=np.uint64)
    b = rng.integers(0, q, size=64, dtype=np.uint64)
    want = eltwise_mult_mod(a, b, q, device="cpu")
    out = eltwise_mult_mod(to_tensor(a, "cpu"), to_tensor(b, "cpu"), q)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(to_numpy(out), want)
    mixed = eltwise_mult_mod(a, to_tensor(b, "cpu"), q)
    assert isinstance(mixed, np.ndarray)
    np.testing.assert_array_equal(mixed, want)
    with pytest.raises(ValueError):
        eltwise_mult_mod(a, b, q, 3, device="cpu")
    with pytest.raises(ValueError):
        eltwise_mult_mod(a, b[:10], q, device="cpu")
    with pytest.raises(ValueError):
        eltwise_mult_mod(a, b, 1 << 62, device="cpu")


@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
def test_poly_mult_mod_vs_jax(n):
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    rng = np.random.default_rng(n)
    a = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    b = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    got = poly_mult_mod(a, b, n, q, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jax_poly_mult_mod(a, b, n,
                                                                    q)))


def test_poly_mult_mod_schoolbook_and_errors():
    n = 16
    q = jnt.generate_primes(1, 61, True, ntt_size=n)[0]
    rng = np.random.default_rng(5)
    a = rng.integers(0, q, size=n, dtype=np.uint64)
    b = rng.integers(0, q, size=n, dtype=np.uint64)
    school = [0] * n
    for i in range(n):
        for j in range(n):
            k, s = (i + j, 1) if i + j < n else (i + j - n, -1)
            school[k] += s * int(a[i]) * int(b[j])
    got = poly_mult_mod(to_tensor(a, "cpu"), to_tensor(b, "cpu"), n, q)
    assert isinstance(got, torch.Tensor)
    assert [int(v) for v in to_numpy(got)] == [v % q for v in school]
    with pytest.raises(ValueError):
        poly_mult_mod(a, b[:8], n, q, device="cpu")
    # N = 2^15 runs the staged route (the two-pass split) and matches the
    # oracle product.
    big = 1 << 15
    qb = jnt.generate_primes(1, 50, True, ntt_size=big)[0]
    jp = jax_get_plan(big, qb)
    ab, bb = (rng.integers(0, qb, size=big, dtype=np.uint64) for _ in range(2))
    fa = ref.fwd_ntt_radix2(ab, qb, jp.rop, jp.prop, 1, 1)
    fb = ref.fwd_ntt_radix2(bb, qb, jp.rop, jp.prop, 1, 1)
    prod = (fa.astype(object) * fb.astype(object) % qb).astype(np.uint64)
    np.testing.assert_array_equal(
        poly_mult_mod(ab, bb, big, qb, device="cpu"),
        ref.inv_ntt_radix2(prod, qb, jp.irop, jp.pirop, 1, 1))


def test_graft_entry_pipeline_vs_jax_step():
    import __graft_entry__
    step, (a_l, b_l) = __graft_entry__.entry()
    a, b = from_limbs(a_l), from_limbs(b_l)
    n = a.shape[-1]
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    want = from_limbs(step(a_l, b_l))
    engine = NTT(n, q, device="cpu")
    fa = engine.forward(to_tensor(a, "cpu"), 1, 4)
    fb = engine.forward(to_tensor(b, "cpu"), 1, 4)
    got = engine.inverse(eltwise_mult_mod(fa, fb, q, 4), 1, 1)
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(poly_mult_mod(a, b, n, q, device="cpu"),
                                  want)
