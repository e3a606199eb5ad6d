"""The FFT-like of CKKS encode/decode (plain versions, CPU) against JAX.

Held against `hexl_tpu.experimental`:
- the f64 and double-float tables, bit for bit;
- the plain double-float walk, bit for bit, against the JAX package's eager
  flat walks `_stage_loop_fwd_df`/`_stage_loop_inv_df` (separate IEEE
  float32 ops, as the port's are);
- "f64" and "single" against the public `FFTLike` of the same precision
  (relative 1e-13 and 2e-5: XLA may contract the complex products there);
- "double_float" against the Pallas kernel `pallas_fft.fwd_fft_df/
  inv_fft_df` in interpret mode and the public transform, by the combined
  hi + lo value at relative 1e-12, the JAX suite's own rule (its 2D walk
  scales the joined output where the flat walk scales the last stage's
  terms, and XLA-CPU jit may contract);
- `build_floating_points` on the reference's golden vector, bit for bit,
  and the device compose at rtol 3e-14.
The split of n > 2^13 (the plain versions of K13 and K12) is held bit for
bit against the flat walk at 2^14 in every precision.
"""

import numpy as np
import pytest
import torch

from hexl_tpu.experimental import df32 as jdf
from hexl_tpu.experimental import fft_like as jfl
from hexl_tpu.experimental import pallas_fft
from hexl_tpu_torch import FFTLike
from hexl_tpu_torch.experimental import cuda_fft, df32, fft_like
from tests.torch_threads import one_torch_thread  # noqa: F401

PRECISIONS = ("f64", "single", "double_float")


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _jax_planes(c):
    return [np.asarray(p) for p in (c.re.hi, c.re.lo, c.im.hi, c.im.lo)]


def _planes(c):
    return [p.numpy() for p in cuda_fft.planes(c, "double_float")]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("n", [16, 1024, 1 << 14])
def test_tables_bit_equal_to_jax(n):
    ours = FFTLike(n, precision="f64", device="cpu")
    theirs = jfl.FFTLike(n, precision="f64")
    np.testing.assert_array_equal(ours.fwd_table.numpy(),
                                  np.asarray(theirs.fwd_table))
    np.testing.assert_array_equal(ours.inv_table.numpy(),
                                  np.asarray(theirs.inv_table))
    ours = FFTLike(n, 2.0 ** 40, precision="double_float", device="cpu")
    theirs = jfl.FFTLike(n, 2.0 ** 40, precision="double_float")
    for a, b in ((ours.fwd_table, theirs.fwd_table),
                 (ours.inv_table, theirs.inv_table)):
        for p, q in zip(_planes(a), _jax_planes(b)):
            np.testing.assert_array_equal(p, q)
    for a, b in ((ours._scale_df, theirs._scale_df),
                 (ours._inv_scale_df, theirs._inv_scale_df)):
        assert float(a.hi) == float(np.asarray(b.hi))
        assert float(a.lo) == float(np.asarray(b.lo))


@pytest.mark.parametrize("n", [16, 1024])
@pytest.mark.parametrize("scalar", [None, 2.0 ** 20, 3.7])
def test_df_walk_bit_equal_to_jax_eager(n, scalar):
    """The plain double-float walk, op for op the JAX eager flat walk:
    every plane bit-equal, the inverse's cdf_mul final stage included."""
    ours = FFTLike(n, scalar, precision="double_float", device="cpu")
    theirs = jfl.FFTLike(n, scalar, precision="double_float")
    z = _complex((3, n), n)
    zc = jdf.cdf_from_complex128(z)
    cases = ((ours.df_fwd_body, ours._inv_scale_df, jfl._stage_loop_fwd_df,
              theirs.fwd_table, theirs._inv_scale_df),
             (ours.df_inv_body, ours._scale_df, jfl._stage_loop_inv_df,
              theirs.inv_table, theirs._scale_df))
    for body, scal, walk, table, jscal in cases:
        got = body(df32.cdf_from_complex128(z), scal)
        want = walk(zc, table, n, jscal)
        for p, q in zip(_planes(got), _jax_planes(want)):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("precision,tol", [("f64", 1e-13), ("single", 2e-5)])
@pytest.mark.parametrize("n,scalar", [(64, None), (1024, 2.0 ** 30)])
def test_complex_precisions_match_jax(precision, tol, n, scalar):
    ours = FFTLike(n, scalar, precision=precision, device="cpu")
    theirs = jfl.FFTLike(n, scalar, precision=precision)
    z = _complex((2, n), n + 1)
    for direction in ("forward", "inverse"):
        got = getattr(ours, direction)(z)
        assert got.dtype == (np.complex64 if precision == "single"
                             else np.complex128)
        assert _rel(got, getattr(theirs, direction)(z)) < tol, direction


@pytest.mark.parametrize("scalar", [None, 2.0 ** 20])
def test_df_matches_pallas_kernel_interpret(scalar):
    """The port's double-float bodies against the JAX Pallas FFT kernel
    (interpret mode on the CPU) at n = 1024, batch 2."""
    n = 1024
    ours = FFTLike(n, 2.0 ** 20, precision="double_float", device="cpu")
    theirs = jfl.FFTLike(n, 2.0 ** 20, precision="double_float")
    z = _complex((2, n), 5)
    zc = jdf.cdf_from_complex128(z)
    for body, scal, kernel, jscal in (
            (ours.df_fwd_body, ours._inv_scale_df, pallas_fft.fwd_fft_df,
             theirs._inv_scale_df),
            (ours.df_inv_body, ours._scale_df, pallas_fft.inv_fft_df,
             theirs._scale_df)):
        got = df32.cdf_to_complex128(body(
            df32.cdf_from_complex128(z), scal if scalar else None))
        want = jdf.cdf_to_complex128(kernel(zc, theirs,
                                            jscal if scalar else None))
        assert _rel(got.numpy(), want) < 1e-12


def test_df_public_matches_jax_public():
    n = 2048
    ours = FFTLike(n, 2.0 ** 30, precision="double_float", device="cpu")
    theirs = jfl.FFTLike(n, 2.0 ** 30, precision="double_float")
    z = _complex((2, n), 6)
    for direction in ("forward", "inverse"):
        assert _rel(getattr(ours, direction)(z),
                    getattr(theirs, direction)(z)) < 1e-12, direction
    assert _rel(ours.forward(ours.inverse(z)), z) < 1e-12


@pytest.mark.parametrize("precision", PRECISIONS)
def test_split_bit_equal_to_flat_walk(precision):
    """Above 2^13 the transform runs the cross pass and the block pass
    (K13 and K12 on the card; their plain versions here): bit-equal to the
    flat walk, with and without a scalar."""
    n = 1 << 14
    z = torch.from_numpy(_complex((2, n), 7))
    for scalar in (None, 2.0 ** 40):
        fft = FFTLike(n, scalar, precision=precision, device="cpu")
        fwd, inv = fft.tables("cpu")
        v = (df32.cdf_from_complex128(z) if precision == "double_float"
             else z.to(fft_like._CTYPE[precision]))
        for forward, table in ((True, fwd), (False, inv)):
            s = fft.fused_scale(forward)
            fn = cuda_fft.forward if forward else cuda_fft.inverse
            got = cuda_fft.planes(fn(v, table, s, precision), precision)
            want = cuda_fft.planes(cuda_fft.walk_plain(v, table, s, precision,
                                                       forward), precision)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        if scalar is not None:
            back = fft.forward(fft.inverse(z.numpy()))
            assert _rel(back, z.numpy()) < (1e-4 if precision == "single"
                                            else 1e-12)


def test_build_floating_points_golden():
    """The reference's golden vector (TEST(FFTLike,
    BuildFloatingPointsAVX512), as tests/test_experimental.py carries it)
    through the port's host compose, bit for bit."""
    operand = [
        17713475508538179584, 27, 0, 0, 16858552366855081984, 1, 0, 0,
        18174255346774966272, 7, 0, 0, 1459965302409322496, 0, 0, 0,
        10852157353743343297, 72057091796482622, 0, 0,
        11766836204861046465, 72057091796482623, 0, 0,
        2950642535971380929, 72057091796482619, 0, 0,
        17395534788117004288, 3, 0, 0, 0, 0, 0, 0,
        18086411410077564609, 72057091796482622, 0, 0,
        14084559588513677312, 7, 0, 0, 5268365919623979008, 3, 0, 0,
        6183044770741665792, 4, 0, 0,
        15575236822075680449, 72057091796482626, 0, 0,
        17307690851419578049, 72057091796482618, 0, 0,
        176649757629939393, 72057091796482625, 0, 0]
    expected = [469095144.125, 32109980.057216156, 133969900.94656014,
                1327830.7073135898, -72732310.45981437, -55123198.89089907,
                -130250344.32255825, 66152794.724299073, 0.0,
                -66152794.724299081, 130250344.32255828, 55123198.89089907,
                72732310.459814355, -1327830.7073136102,
                -133969900.94656017, -32109980.05721616]
    threshold = [8517601062242512737, 36028545898241313, 0, 0]
    dec_modulus = [17035202124485025473, 72057091796482626, 0, 0]
    plain = np.array(operand, dtype=np.uint64).reshape(16, 4).T
    fft = FFTLike(16, device="cpu")
    out = fft.build_floating_points(plain, threshold, dec_modulus,
                                    1.0 / (1 << 40))
    np.testing.assert_array_equal(out.real, np.array(expected))
    np.testing.assert_array_equal(out.imag, np.zeros(16))
    dev = df32.df_to_f64(fft.build_floating_points_device(
        plain, threshold, dec_modulus, 1.0 / (1 << 40))).numpy()
    np.testing.assert_allclose(dev, np.array(expected), rtol=3e-14,
                               atol=1e-20)


def test_build_floating_points_device_matches_jax():
    """The device compose (float64, split into hi/lo at the end) against
    the JAX package's double-float compose and the host version, on the
    JAX test's 2-word values, negatives included."""
    n, mod_size = 64, 2
    rng = np.random.default_rng(9)
    dec = (1 << 100) + 12345
    thr = dec >> 1
    vals = [(int(rng.integers(0, 1 << 62)) << 40
             | int(rng.integers(0, 1 << 40))) % dec for _ in range(n)]
    plain = np.zeros((mod_size, n), dtype=np.uint64)
    for i, v in enumerate(vals):
        for w in range(mod_size):
            plain[w, i] = (v >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
    thr_words = [(thr >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
                 for w in range(mod_size)]
    dec_words = [(dec >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
                 for w in range(mod_size)]
    ours = FFTLike(n, precision="double_float", device="cpu")
    theirs = jfl.FFTLike(n, precision="double_float")
    got = ours.build_floating_points_device(plain, thr_words, dec_words,
                                            2.0 ** -40)
    assert got.hi.dtype == torch.float32 and got.hi.shape == (n,)
    want = jdf.df_to_f64(theirs.build_floating_points_device(
        plain, thr_words, dec_words, 2.0 ** -40))
    got = df32.df_to_f64(got).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-14, atol=1e-20)
    host = theirs.build_floating_points(plain, thr_words, dec_words,
                                        2.0 ** -40)
    np.testing.assert_allclose(got, host.real, rtol=3e-14, atol=1e-20)
    assert (got < 0).any() and (got > 0).any()


def test_arguments_and_forms():
    with pytest.raises(ValueError, match="power of two"):
        FFTLike(24, device="cpu")
    with pytest.raises(ValueError, match="bigger than 8"):
        FFTLike(8, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        FFTLike(16, precision="half", device="cpu")
    assert FFTLike(16, device="cpu").precision == "f64"
    fft = FFTLike(16, 4.0, device="cpu")
    z = _complex((3, 16), 8)
    out = fft.forward(torch.from_numpy(z))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.complex128
    np.testing.assert_array_equal(out.numpy(), fft.forward(z))
    with pytest.raises(ValueError, match="double_float"):
        fft.df_fwd_body(df32.cdf_from_complex128(z))
    cdf = FFTLike(16, 4.0, precision="double_float", device="cpu").df_fwd_body(
        df32.cdf_from_complex128(z))
    assert isinstance(cdf, df32.CDF) and cdf.re.hi.dtype == torch.float32
    with pytest.raises(ValueError, match="power of two above 8"):
        cuda_fft.forward(torch.from_numpy(z[:, :8]), fft.fwd_table, None,
                         "f64")
    with pytest.raises(TypeError):
        cuda_fft.forward(torch.from_numpy(z).to(torch.complex64),
                         fft.fwd_table, None, "f64")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_lazy_conjugate_input(precision):
    """A lazy conjugate (z.conj()) transforms as the conjugate it stands
    for: FFTLike resolves it before the kernels, which read memory, and
    the wrappers refuse one."""
    fft = FFTLike(64, 2.0 ** 20, precision=precision, device="cpu")
    z = torch.from_numpy(_complex((2, 64), 10))
    lazy, eager = z.conj(), z.conj().resolve_conj()
    assert lazy.is_conj() and not eager.is_conj()
    for direction in ("forward", "inverse"):
        got = getattr(fft, direction)(lazy)
        want = getattr(fft, direction)(eager)
        assert torch.equal(got, want), direction
    with pytest.raises(ValueError, match="conjugate"):
        cuda_fft.forward(lazy, FFTLike(64, device="cpu").fwd_table, None,
                         "f64")
    cdf = df32.cdf_from_complex128(z)
    negated = torch._neg_view(cdf.im.hi)    # contiguous, negative bit set
    assert negated.is_neg() and negated.is_contiguous()
    with pytest.raises(ValueError, match="conjugate"):
        cuda_fft.forward(df32.CDF(cdf.re, df32.DF(negated, cdf.im.lo)),
                         FFTLike(64, precision="double_float",
                                 device="cpu").fwd_table, None,
                         "double_float")


def _op_count(fn):
    """The element-wise adds, subtracts and multiplies fn runs, on 0-d
    tensors (negations free)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__
            if name.startswith(("add", "sub", "mul", "rsub")):
                Count.ops += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.ops


@pytest.mark.parametrize("precision", PRECISIONS)
def test_bound_op_counts_match_plain_arithmetic(precision):
    """chip_smoke.py's FFT_COST, the operation term of K12/K13's bound,
    is what the plain arithmetic runs: the presplit product is "mul" plus
    one twiddle's "split"."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cost = smoke.FFT_COST[precision]
    ar = fft_like.arith(precision)
    dtype = torch.float32 if precision != "f64" else torch.float64
    width = 4 if precision == "double_float" else 2
    v = tuple(torch.tensor(1.234567 * (i + 1), dtype=dtype)
              for i in range(width))
    s = (df32.DF(torch.tensor(0.3, dtype=dtype),
                 torch.tensor(1e-9, dtype=dtype))
         if precision == "double_float" else 0.3)
    assert _op_count(lambda: ar.mul(v, v)) == cost["mul"] + cost["split"]
    assert _op_count(lambda: ar.add(v, v)) == cost["add"]
    assert _op_count(lambda: ar.sub(v, v)) == cost["add"]
    assert _op_count(lambda: ar.scale(v, s)) == cost["scale"]
    assert _op_count(lambda: ar.mul_full(v, v)) == cost["mul_full"]
    # Whole passes at n = 2^14, block 2^13, batch 1, with a scalar: every
    # stage's butterflies, splits and fused scales.
    bfly = (1 << 13) * (cost["mul"] + 2 * cost["add"])
    assert smoke.fft_pass_ops(precision, 1 << 14, 1, 1 << 13, True, True,
                              True) == bfly + cost["split"]
    assert smoke.fft_pass_ops(precision, 1 << 14, 1, 1 << 13, False, True,
                              True) == ((1 << 13) * (2 * cost["add"]
                                                     + cost["scale"]
                                                     + cost["mul_full"])
                                        + cost["scale"])
    assert smoke.fft_pass_ops(precision, 1 << 14, 1, 1 << 13, True, False,
                              True) == (13 * bfly + ((1 << 14) - 2)
                                        * cost["split"]
                                        + ((1 << 13) * 2) * cost["scale"])
