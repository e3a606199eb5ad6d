"""K17's and K18's plain versions against the JAX chains they port, and the
approximate quotient they rest on against `hexl_tpu.limb`.

K17 is `benchmarks/mosaic_butterfly_ab.py`'s chain of lean16 forward
butterflies (and its exact-Harvey sibling), K18
`benchmarks/mosaic_df_bfly_ab.py`'s chain of double-float butterflies with
the closing scale; both on 64 x 128 planes here (the probes' are 16384 x
128 and 8192 x 128). The JAX double-float chain runs eagerly: op by op,
as the port's plain version, so no multiply-add is contracted on either
side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hexl_tpu import limb as jlimb
from hexl_tpu.experimental import df32 as JD
from hexl_tpu.experimental.fft_like import _bfly_fwd_df
from hexl_tpu.ntt.jnp_ntt import _fwd_butterfly, _fwd_butterfly_lean16
from hexl_tpu_torch import limb
from hexl_tpu_torch.experimental import df32 as D
from hexl_tpu_torch.experimental import df_chain
from hexl_tpu_torch.ntt import chain

ROWS, LANES = 64, 128


def _jax_ntt_chain(x, y, w, q, reps, bfly):
    consts = tuple(jlimb.const64(v) for v in
                   (w, chain.precondition(w, q), q, 2 * q))

    @jax.jit
    def run(xx, yy):
        for _ in range(reps):
            nx, ny = bfly(xx, yy, *consts)
            xx, yy = ny, nx
        return xx, yy

    ox, oy = run(jlimb.to_limbs(x), jlimb.to_limbs(y))
    return jlimb.from_limbs(ox), jlimb.from_limbs(oy)


@pytest.mark.parametrize("scheme", ["lean16", "exact"])
def test_k17_plain_vs_jax_chain(scheme):
    rng = np.random.default_rng(17)
    x, y = chain.probe_inputs(rng, "cpu", ROWS, LANES)
    got = chain.chain(x, y, chain.PROBE_W, chain.PROBE_Q, chain.REPS, scheme)
    bfly = _fwd_butterfly_lean16 if scheme == "lean16" else _fwd_butterfly
    want = _jax_ntt_chain(limb.to_numpy(x), limb.to_numpy(y), chain.PROBE_W,
                          chain.PROBE_Q, chain.REPS, bfly)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(limb.to_numpy(g), w)
    # The lean chain's values differ from the exact one's but agree mod q.
    exact = chain.chain_plain(x, y, chain.PROBE_W, chain.PROBE_Q,
                              chain.REPS, "exact")
    q = np.uint64(chain.PROBE_Q)
    for g, e in zip(got, exact):
        np.testing.assert_array_equal(limb.to_numpy(g) % q,
                                      limb.to_numpy(e) % q)


def test_k17_refuses_bad_operands():
    x = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        chain.chain(x, x, chain.PROBE_W, chain.PROBE_Q, scheme="lean8")
    with pytest.raises(ValueError):
        chain.chain(x, x[:1], chain.PROBE_W, chain.PROBE_Q)
    with pytest.raises(ValueError):
        chain.chain(x, x, chain.PROBE_Q, chain.PROBE_Q)
    big = (1 << 60) + 1
    with pytest.raises(ValueError):
        chain.chain(x, x, 3, big)


def test_k18_plain_vs_jax_chain():
    rng = np.random.default_rng(18)
    zx, zy = (rng.normal(size=(ROWS, LANES))
              + 1j * rng.normal(size=(ROWS, LANES)) for _ in range(2))
    w = df_chain.twiddle("double_float", "cpu")
    s = df_chain.shrink("double_float")
    got = df_chain.chain(D.cdf_from_complex128(zx), D.cdf_from_complex128(zy),
                         w, s, "double_float")
    jw = JD.CDF(JD.DF(jnp.float32(w.re.hi[0]), jnp.float32(w.re.lo[0])),
                JD.DF(jnp.float32(w.im.hi[0]), jnp.float32(w.im.lo[0])))
    jx, jy = JD.cdf_from_complex128(zx), JD.cdf_from_complex128(zy)
    for _ in range(df_chain.REPS):
        nx, ny = _bfly_fwd_df(jx, jy, jw)
        jx, jy = ny, nx
    js = JD.DF(jnp.float32(s.hi), jnp.float32(s.lo))
    want = (JD.cdf_scale(jx, js), JD.cdf_scale(jy, js))
    for g, v in zip(got, want):
        for gp, wp in ((g.re.hi, v.re.hi), (g.re.lo, v.re.lo),
                       (g.im.hi, v.im.hi), (g.im.lo, v.im.lo)):
            assert gp.dtype == torch.float32
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("precision", ["f64", "single"])
def test_k18_other_precisions_vs_numpy(precision):
    """The f64 and single chains are the same butterflies in complex
    arithmetic: within rounding of a complex128 reference."""
    rng = np.random.default_rng(19)
    zx, zy = (rng.normal(size=(ROWS, LANES))
              + 1j * rng.normal(size=(ROWS, LANES)) for _ in range(2))
    dtype = torch.complex128 if precision == "f64" else torch.complex64
    got = df_chain.chain(torch.tensor(zx, dtype=dtype),
                         torch.tensor(zy, dtype=dtype),
                         df_chain.twiddle(precision, "cpu"),
                         df_chain.shrink(precision), precision)
    wz = np.exp(1j * df_chain.ANGLE)
    x, y = zx, zy
    for _ in range(df_chain.REPS):
        x, y = x - y * wz, x + y * wz
    tol = 1e-12 if precision == "f64" else 1e-5
    for g, v in zip(got, (x * 2.0 ** -8, y * 2.0 ** -8)):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.numpy(), v, rtol=0, atol=tol)


def _edges():
    top = (1 << 64) - 1
    vals = [0, 1, 2, 0xFFFF, 0x10000, 0xFFFFFFFF, 1 << 32, (1 << 32) + 1,
            1 << 63, (1 << 63) - 1, top, top - 1, 0x8000000080000000,
            0x7FFFFFFF7FFFFFFF, 0xFFFF0000FFFF0000, 0x0000FFFF0000FFFF]
    return np.array(vals, dtype=np.uint64)


def test_mulhi64_approx6_vs_jax():
    rng = np.random.default_rng(64)
    e = _edges()
    xs = np.concatenate([np.repeat(e, e.size), rng.integers(
        0, 1 << 64, size=4096, dtype=np.uint64)])
    ys = np.concatenate([np.tile(e, e.size), rng.integers(
        0, 1 << 64, size=4096, dtype=np.uint64)])
    got = limb.to_numpy(limb.mulhi64_approx6(limb.to_tensor(xs, "cpu"),
                                             limb.to_tensor(ys, "cpu")))
    want = jlimb.from_limbs(jlimb.mulhi64_approx6(jlimb.to_limbs(xs),
                                                  jlimb.to_limbs(ys)))
    np.testing.assert_array_equal(got, want)
    exact = np.array([(int(a) * int(b)) >> 64 for a, b in zip(xs, ys)],
                     dtype=object)
    err = exact - np.array([int(v) for v in got], dtype=object)
    assert err.min() >= 0 and err.max() <= 6
    # A Python-int multiplier (a precondition) gives the same bits.
    wp = int(ys[-1])
    one = limb.mulhi64_approx6(limb.to_tensor(xs, "cpu"), limb.s64(wp))
    np.testing.assert_array_equal(
        limb.to_numpy(one), jlimb.from_limbs(jlimb.mulhi64_approx6(
            jlimb.to_limbs(xs), jlimb.const64(wp))))


def test_hi32_approx_vs_jax():
    rng = np.random.default_rng(32)
    e = np.array([0, 1, 0xFFFF, 0x10000, 0x1FFFF, 0xFFFFFFFF, 0x80000000,
                  0x7FFFFFFF, 0xFFFF0000, 0x0000FFFF], dtype=np.uint32)
    a = np.concatenate([np.repeat(e, e.size),
                        rng.integers(0, 1 << 32, 4096, dtype=np.uint32)])
    b = np.concatenate([np.tile(e, e.size),
                        rng.integers(0, 1 << 32, 4096, dtype=np.uint32)])
    got = limb.hi32_approx(torch.from_numpy(a.astype(np.int64)),
                           torch.from_numpy(b.astype(np.int64))).numpy()
    want = np.asarray(jlimb.hi32_approx(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    exact = (a.astype(np.uint64) * b.astype(np.uint64)) >> np.uint64(32)
    diff = exact.astype(np.int64) - got
    assert diff.min() >= 0 and diff.max() <= 2
