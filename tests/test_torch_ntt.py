"""The port's NTT on the CPU (its plain versions) against the JAX package.

Plans and their tables against `hexl_tpu.ntt.get_plan`; transforms across
the whole IMF/OMF matrix against the NumPy oracle `hexl_tpu.ref` (lazy
outputs included, bit for bit); the golden vectors; batching, numpy/tensor
in and out, and the errors of the public engine.
"""

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu_torch import NTT, get_plan, nt, plan_from_arrays
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import cuda_ntt, torch_ntt
from tests.test_ref_ntt import GOLDEN
from tests.torch_threads import one_torch_thread  # noqa: F401


def _prime(q_bits, n):
    return jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]


@pytest.mark.parametrize("log_n,q_bits", [(1, 30), (3, 60), (6, 50),
                                          (10, 61), (12, 30), (14, 60),
                                          (17, 29)])
def test_plan_tables_match_jax(log_n, q_bits):
    n = 1 << log_n
    q = _prime(q_bits, n)
    mine, theirs = get_plan(n, q), jax_get_plan(n, q)
    assert mine.root == theirs.root
    for name in ("rop", "prop", "irop", "pirop"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name), err_msg=name)
    for name in ("inv_n", "inv_n_precon", "inv_n_w", "inv_n_w_precon"):
        assert getattr(mine, name) == getattr(theirs, name), name
    tabs = mine.tables("cpu")
    np.testing.assert_array_equal(to_numpy(tabs["pirop"]), theirs.pirop)


@pytest.mark.parametrize("log_n,q_bits", [(4, 50), (12, 60)])
def test_plan_from_arrays_carries_jax_tables(log_n, q_bits):
    n = 1 << log_n
    q = _prime(q_bits, n)
    jp = jax_get_plan(n, q)
    carried = plan_from_arrays(n, q, jp.root, jp.rop, jp.prop, jp.irop,
                               jp.pirop)
    own = get_plan(n, q)
    rng = np.random.default_rng(log_n)
    x = to_tensor(rng.integers(0, 4 * q, size=(2, n), dtype=np.uint64), "cpu")
    for omf in (1, 4):
        assert torch.equal(torch_ntt.fwd_ntt(x, carried, 4, omf),
                           torch_ntt.fwd_ntt(x, own, 4, omf))
    y = x % (2 * q)
    assert torch.equal(torch_ntt.inv_ntt(y, carried, 2, 2),
                       torch_ntt.inv_ntt(y, own, 2, 2))
    # Tables of another root, or damaged tables, are refused.
    bad = jp.rop.copy()
    bad[n - 1] ^= np.uint64(1)
    with pytest.raises(ValueError):
        plan_from_arrays(n, q, jp.root, bad, jp.prop, jp.irop, jp.pirop)
    with pytest.raises(ValueError):
        plan_from_arrays(n, q, jp.root, jp.rop[:-1], jp.prop, jp.irop,
                         jp.pirop)
    with pytest.raises(ValueError):
        plan_from_arrays(n, q, jp.root + 1, jp.rop, jp.prop, jp.irop,
                         jp.pirop)


@pytest.mark.parametrize("log_n", [1, 3, 6, 9, 10, 12, 14])
@pytest.mark.parametrize("q_bits", [30, 50, 60, 61])
def test_mod_factor_matrix_vs_oracle(log_n, q_bits):
    n = 1 << log_n
    q = _prime(q_bits, n)
    engine = NTT(n, q, device="cpu")
    p = engine.plan
    rng = np.random.default_rng(log_n * 100 + q_bits)
    batch = 2 if log_n >= 12 else 3
    for imf in (1, 2, 4):
        x = rng.integers(0, imf * q, size=(batch, n), dtype=np.uint64)
        for omf in (1, 4):
            got = engine.forward(x, imf, omf)
            want = np.stack([ref.fwd_ntt_radix2(v, q, p.rop, p.prop, imf,
                                                omf) for v in x])
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"fwd {imf} {omf}")
    for imf in (1, 2):
        x = rng.integers(0, imf * q, size=(batch, n), dtype=np.uint64)
        for omf in (1, 2):
            got = engine.inverse(x, imf, omf)
            want = np.stack([ref.inv_ntt_radix2(v, q, p.irop, p.pirop, imf,
                                                omf) for v in x])
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"inv {imf} {omf}")
    y = engine.forward(x % np.uint64(q))
    np.testing.assert_array_equal(engine.inverse(y), x % np.uint64(q))


@pytest.mark.parametrize("n,q,inp,expected", GOLDEN)
def test_golden_vectors(n, q, inp, expected):
    engine = NTT(n, q, device="cpu")
    x = np.array(inp, dtype=np.uint64)
    want = np.array(expected, dtype=np.uint64)
    np.testing.assert_array_equal(engine.forward(x, 1, 1), want)
    out4 = engine.forward(x, 2, 4)
    np.testing.assert_array_equal(out4 % np.uint64(q), want)
    assert np.all(out4 < np.uint64(4 * q))
    np.testing.assert_array_equal(engine.inverse(want, 1, 1), x)


def test_batched_leading_axes():
    n = 256
    q = _prime(50, n)
    engine = NTT(n, q, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=(2, 3, n), dtype=np.uint64)
    got = engine.forward(x)
    assert got.shape == (2, 3, n)
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(
                got[i, j], ref.fwd_ntt_radix2(x[i, j], q, engine.plan.rop,
                                              engine.plan.prop, 1, 1))
    np.testing.assert_array_equal(engine.inverse(got), x)


def test_numpy_and_tensor_in_and_out():
    n = 64
    q = _prime(60, n)
    engine = NTT(n, q, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.integers(0, q, size=(4, n), dtype=np.uint64)
    out_np = engine.forward(x)
    assert isinstance(out_np, np.ndarray) and out_np.dtype == np.uint64
    xt = to_tensor(x, "cpu")
    out_t = engine.forward(xt)
    assert isinstance(out_t, torch.Tensor) and out_t.dtype == torch.int64
    assert out_t.device == xt.device
    np.testing.assert_array_equal(to_numpy(out_t), out_np)
    # A non-contiguous tensor view is accepted by the engine.
    view = to_tensor(np.concatenate([x, x], axis=1), "cpu")[:, ::2]
    assert not view.is_contiguous()
    assert torch.equal(engine.forward(view), engine.forward(view.contiguous()))
    assert torch.equal(engine.inverse(out_t), xt)
    np.testing.assert_array_equal(engine.root_of_unity_powers(),
                                  engine.plan.rop)
    np.testing.assert_array_equal(engine.inv_root_of_unity_powers(),
                                  engine.plan.irop)
    assert engine.root == nt.minimal_primitive_root(2 * n, q)


@pytest.mark.parametrize("n,batch,expected", [
    (2, 1, 1), (2, 32, 32), (16, 3, 2), (16, 8192, 16), (1024, 8, 1),
    (1024, 256, 1), (1024, 401, 1), (1024, 4096, 1), (32, 4096, 8),
    (4096, 1, 1), (4096, 2, 1), (4096, 263, 1), (4096, 264, 1),
    (8192, 64, 1), (16384, 256, 1), (4, 4096, 64), (8, 4096, 32),
    (64, 8192, 4), (128, 4096, 2), (256, 8192, 1)])
def test_polys_per_cta(n, batch, expected):
    """K2 packs where one polynomial gives a CTA of less than a warp (N <
    2^8): as many as make a CTA of 256 coefficients, at most the largest
    power of two in the batch; everything else runs one per CTA (K1)."""
    assert cuda_ntt.polys_per_cta(n, batch) == expected
    if expected > 1:
        assert expected <= batch and expected & (expected - 1) == 0
        assert expected * n <= cuda_ntt.PACK_COEFFS
        assert expected <= cuda_ntt.max_polys_per_cta(n)


def test_errors():
    n = 64
    q = _prime(50, n)
    engine = NTT(n, q, device="cpu")
    x = np.zeros(n, dtype=np.uint64)
    for imf, omf in ((3, 1), (1, 2), (8, 1)):
        with pytest.raises(ValueError):
            engine.forward(x, imf, omf)
    for imf, omf in ((4, 1), (1, 4), (3, 2)):
        with pytest.raises(ValueError):
            engine.inverse(x, imf, omf)
    with pytest.raises(ValueError):
        engine.forward(np.zeros(n // 2, dtype=np.uint64))
    with pytest.raises(TypeError):
        cuda_ntt.fwd_ntt(torch.zeros(n, dtype=torch.int32), engine.plan)
    with pytest.raises(ValueError):
        cuda_ntt.fwd_ntt(torch.zeros(2 * n, dtype=torch.int64)[::2],
                         engine.plan)
    with pytest.raises(ValueError, match="prime"):
        NTT(n, (2 * n + 1) ** 2, device="cpu")   # = 1 mod 2N, composite
    with pytest.raises(ValueError, match="1 mod 2N"):
        NTT(n, 97, device="cpu")                 # prime, != 1 mod 2N
    with pytest.raises(ValueError):
        NTT(48, q, device="cpu")
    # The degree range ends at 2^20: N = 2^15 (the two-pass split) works,
    # N = 2^21 is refused by the argument check.
    big = 1 << 15
    qb = _prime(50, big)
    xb = np.random.default_rng(big).integers(0, qb, size=big, dtype=np.uint64)
    engine = NTT(big, qb, device="cpu")
    np.testing.assert_array_equal(engine.inverse(engine.forward(xb)), xb)
    with pytest.raises(ValueError, match="exceeds"):
        NTT(1 << 21, _prime(50, 1 << 21), device="cpu")
