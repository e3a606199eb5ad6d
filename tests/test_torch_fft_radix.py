"""A model of K12's radix walk (csrc/fft.cu fft_radix_fwd_kernel and
fft_radix_inv_kernel) on torch tensors, held bit for bit against the plain
walks.

The model runs the kernel's pass schedule, one pass at a time over all
groups at once: the transform of n = 2^log_n cut into groups of R = 8
values (R = 2 below n = 8), group u holding base(u) + i 2^s in the pass
whose register bits sit at s (radix.cuh radix_base); passes of up to three
stages; the twiddle of block c of the stage of register bit j at
(g >> j) + c, with g formed once a pass as radix_fwd_g/radix_inv_g form
it; the forward's scalar in the stride-1 stage (j = 0 of the pass at
s = 0), the inverse's in its fused final stage (a whole transform only).
Its arithmetic is the plain walks' (`fft_like.arith`), so any index error
of the schedule shows as a difference against them:
- `cuda_fft.walk_plain`/`block_plain` and the flat stages of `fft_like`
  in f64, single and double-float, for log_n 1..13 and log_d 0..4, with
  and without a scalar;
- the JAX `FFTLike` at n <= 2^10 (the double-float walk bit for bit
  against its eager flat walks, f64 and single within the tolerances of
  tests/test_torch_fft.py).
"""

import functools

import numpy as np
import pytest
import torch

from hexl_tpu.experimental import df32 as jdf
from hexl_tpu.experimental import fft_like as jfl
from hexl_tpu_torch import FFTLike
from hexl_tpu_torch.experimental import cuda_fft, df32, fft_like
from tests.torch_threads import one_torch_thread  # noqa: F401

PRECISIONS = ("f64", "single", "double_float")


def _logr(log_n):
    return 3 if log_n >= 3 else 1


def _base(u, s, logr):
    return (u & ((1 << s) - 1)) | ((u >> s) << (s + logr))


def _fwd_g(first_block, log_n, s, u, logr):
    return (first_block << (log_n - 1 - s)) + ((u >> s) << (logr - 1))


def _inv_g(shard, log_n, log_big_n, s, u, logr):
    return ((shard << (log_n - 1 - s)) - (1 << (log_big_n - s))
            + ((u >> s) << (logr - 1)))


def _gather(x, idx):
    return tuple(p[:, idx] for p in x)


def _blocks(j, logr):
    """(lo, hi, c) of the butterflies of the stage of register bit j: the
    register pairs (I, I + 2^j) and the block c of each."""
    lo = [(c << (j + 1)) + k for c in range(1 << (logr - 1 - j))
          for k in range(1 << j)]
    return (torch.tensor(lo), torch.tensor(lo) + (1 << j),
            torch.tensor([i >> (j + 1) for i in lo]))


def _twiddles(table, at):
    return tuple(p[at] for p in table)


def _put(v, idx, val):
    for p, q in zip(v, val):
        p[..., idx] = q


def radix_model(x, table, scalar, precision, forward, log_n, log_d):
    """K12's radix walk on x (rows of n = 2^log_n values; row r is block
    r mod 2^log_d of its transform), as the kernel schedules it."""
    ar = fft_like.arith(precision)
    logr = _logr(log_n)
    rows = x[0].shape[0]
    n = 1 << log_n
    u = torch.arange(n >> logr)
    shard = torch.arange(rows) % (1 << log_d)
    i = torch.arange(1 << logr)
    passes = (log_n + logr - 1) // logr
    x = tuple(p.clone() for p in x)
    fused = not forward and log_d == 0 and scalar is not None
    for p in range(passes):
        if forward:
            hi = log_n - p * logr
            s = max(hi - logr, 0)
            stages = range(hi - s - 1, -1, -1)
            g = _fwd_g((1 << log_d) + shard[:, None], log_n, s, u[None, :],
                       logr)
        else:
            lo, hi = p * logr, min(p * logr + logr, log_n)
            s = min(lo, log_n - logr)
            last = p == passes - 1
            stages = range(lo - s, hi - s - (fused and last))
            g = _inv_g(shard[:, None], log_n, log_n + log_d, s, u[None, :],
                       logr)
        idx = _base(u, s, logr)[:, None] + (i[None, :] << s)
        assert sorted(idx.flatten().tolist()) == list(range(n))
        v = tuple(t.reshape(rows, *idx.shape) for t in _gather(x, idx))
        for j in stages:
            lo_r, hi_r, c = _blocks(j, logr)
            at = (g >> j)[:, :, None] + c[None, None, :]
            if not forward:   # g is relative to table entry 1 + N
                at = at + 1 + (1 << (log_n + log_d))
            w = _twiddles(table, at)
            a = tuple(t[..., lo_r] for t in v)
            b = tuple(t[..., hi_r] for t in v)
            if forward:
                if j == 0 and s == 0 and scalar is not None:
                    w = ar.scale(w, scalar)
                    a = ar.scale(a, scalar)
                t = ar.mul(b, w)
                _put(v, lo_r, ar.add(a, t))
                _put(v, hi_r, ar.sub(a, t))
            else:
                _put(v, lo_r, ar.add(a, b))
                _put(v, hi_r, ar.mul(ar.sub(a, b), w))
        if fused and p == passes - 1:
            half = 1 << (logr - 1)
            w = ar.scale(tuple(q[n - 1] for q in table), scalar)
            a = tuple(t[..., :half] for t in v)
            b = tuple(t[..., half:] for t in v)
            lo_v = ar.scale(ar.add(a, b), scalar)
            hi_v = ar.mul_full(ar.sub(a, b), w)
            _put(v, slice(0, half), lo_v)
            _put(v, slice(half, None), hi_v)
        for q, t in zip(x, v):
            q[:, idx] = t.reshape(rows, *idx.shape)
    return x


def _planes_of(z, precision):
    if precision == "double_float":
        return cuda_fft.planes(df32.cdf_from_complex128(z, "cpu"), precision)
    dtype = torch.complex64 if precision == "single" else torch.complex128
    z = z.to(dtype)
    return (z.real.contiguous(), z.imag.contiguous())


@functools.lru_cache(maxsize=None)
def _tables(big_n):
    return fft_like.build_tables(big_n)


def _setup(precision, log_big_n, scalar, seed):
    """(planes of a (1, N) input, forward and inverse table planes, forward
    and inverse scale) for N = 2^log_big_n."""
    big_n = 1 << log_big_n
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(size=(1, big_n))
                         + 1j * rng.normal(size=(1, big_n)))
    tabs = [_planes_of(torch.from_numpy(t)[None], precision)
            for t in _tables(big_n)]
    tabs = [tuple(p[0] for p in t) for t in tabs]
    if scalar is None:
        return _planes_of(z, precision), tabs, None, None
    scales = (1.0 / scalar, scalar / big_n)
    if precision == "double_float":
        scales = tuple(df32.df_from_f64(np.float64(v)) for v in scales)
    elif precision == "single":
        scales = tuple(float(np.float32(v)) for v in scales)
    return _planes_of(z, precision), tabs, scales[0], scales[1]


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("log_n", range(1, 14))
def test_radix_schedule_matches_the_plain_walks(precision, log_n):
    """Every log_d 0..4, with and without a scalar, both directions: the
    model on the blocks of a transform of N = 2^(log_n + log_d) equals the
    flat stages it stands for (all stages for log_d = 0; the forward's
    m >= 2^log_d, the inverse's strides < n for a block of a split)."""
    n = 1 << log_n
    for log_d in range(5):
        big_n = n << log_d
        ar = fft_like.arith(precision)
        for scalar in (None, 2.0 ** 40):
            x, (ft, it), sf, si = _setup(precision, log_n + log_d, scalar,
                                         log_n * 8 + log_d)
            blocks = tuple(p.reshape(-1, n) for p in x)
            for forward, tab, sc in ((True, ft, sf), (False, it, si)):
                got = radix_model(blocks, tab, sc, precision, forward,
                                  log_n, log_d)
                got = tuple(p.reshape(1, big_n) for p in got)
                if log_d == 0:
                    walk = fft_like.fwd_walk if forward else fft_like.inv_walk
                    want = walk(x, tab, n, sc, ar)
                elif forward:
                    want = fft_like.fwd_stages(x, tab, big_n, 1 << log_d,
                                               big_n, sc, ar)
                else:
                    want = fft_like.inv_stages(x, tab, big_n, 1, n, ar)
                assert _equal(got, want), (log_d, scalar, forward)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("log_d", [0, 1, 2])
def test_radix_schedule_matches_the_wrappers_plain_versions(precision, log_d):
    """At log_n = 13, what K12 runs on a whole transform (walk_plain) or
    on the blocks of a split one (block_plain), through FFTLike's own
    tables and scales."""
    n = cuda_fft.BLOCK_N
    big_n = n << log_d
    fft = FFTLike(big_n, 2.0 ** 40, precision=precision, device="cpu")
    tables = fft.tables("cpu")
    z = torch.from_numpy(np.random.default_rng(log_d).normal(
        size=(2, big_n, 2)))
    z = torch.view_as_complex(z)
    v = (df32.cdf_from_complex128(z, "cpu") if precision == "double_float"
         else z.to(fft_like._CTYPE[precision]))
    for forward in (True, False):
        tab = tables[0 if forward else 1]
        s = fft.fused_scale(forward)
        plain = cuda_fft.walk_plain if log_d == 0 else cuda_fft.block_plain
        want = cuda_fft.planes(plain(v, tab, s, precision, forward),
                               precision)
        got = radix_model(
            tuple(p.reshape(-1, n) for p in cuda_fft.planes(v, precision)),
            cuda_fft.planes(tab, precision), s, precision, forward, 13,
            log_d)
        assert _equal(tuple(p.reshape(2, big_n) for p in got), want)


@pytest.mark.parametrize("n", [16, 256])
def test_radix_schedule_double_float_bit_equal_to_jax_eager(n):
    """The model's double-float walk, bit for bit the JAX eager flat walks
    (`_stage_loop_fwd_df`/`_stage_loop_inv_df`) with a scalar."""
    ours = FFTLike(n, 2.0 ** 20, precision="double_float", device="cpu")
    theirs = jfl.FFTLike(n, 2.0 ** 20, precision="double_float")
    z = np.random.default_rng(n).normal(size=(3, n)) \
        + 1j * np.random.default_rng(n + 1).normal(size=(3, n))
    x = cuda_fft.planes(df32.cdf_from_complex128(torch.from_numpy(z), "cpu"),
                        "double_float")
    log_n = n.bit_length() - 1
    for forward, table, scal, walk, jtab, jscal in (
            (True, ours.fwd_table, ours._inv_scale_df,
             jfl._stage_loop_fwd_df, theirs.fwd_table, theirs._inv_scale_df),
            (False, ours.inv_table, ours._scale_df, jfl._stage_loop_inv_df,
             theirs.inv_table, theirs._scale_df)):
        got = radix_model(x, cuda_fft.planes(table, "double_float"), scal,
                          "double_float", forward, log_n, 0)
        want = walk(jdf.cdf_from_complex128(z), jtab, n, jscal)
        for p, q in zip(got, (want.re.hi, want.re.lo, want.im.hi,
                              want.im.lo)):
            np.testing.assert_array_equal(p.numpy(), np.asarray(q))


@pytest.mark.parametrize("precision,tol", [("f64", 1e-13), ("single", 2e-5)])
@pytest.mark.parametrize("n", [16, 1024])
def test_radix_schedule_matches_jax_fft_like(precision, tol, n):
    """f64 and single against the JAX FFTLike's public transforms, within
    tests/test_torch_fft.py's tolerances (XLA may contract its complex
    products)."""
    ours = FFTLike(n, 2.0 ** 30, precision=precision, device="cpu")
    theirs = jfl.FFTLike(n, 2.0 ** 30, precision=precision)
    z = np.random.default_rng(n).normal(size=(2, n)) \
        + 1j * np.random.default_rng(n + 2).normal(size=(2, n))
    x = _planes_of(torch.from_numpy(z), precision)
    log_n = n.bit_length() - 1
    for forward in (True, False):
        table = ours.fwd_table if forward else ours.inv_table
        got = radix_model(x, (table.real, table.imag),
                          ours.fused_scale(forward), precision, forward,
                          log_n, 0)
        got = torch.complex(*got).numpy()
        want = (theirs.forward if forward else theirs.inverse)(z)
        rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert rel < tol, (forward, rel)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_transforms_per_cta_packs_only_below_pack_below(precision):
    """K12 takes one transform per CTA (the radix walk) from PACK_BELOW on
    at any batch; below it, the stage walk's packing rule."""
    polys_per_cta = cuda_fft.stage_walk_packing
    low = cuda_fft.PACK_BELOW[precision]
    for n in (16, low // 2, low, 1 << 10, 1 << 13):
        for batch in (1, 200, 8192):
            got = cuda_fft.transforms_per_cta(n, batch, precision, 132)
            assert got == (1 if n >= low else polys_per_cta(n, batch, 132))
    assert cuda_fft.transforms_per_cta(low // 2, 8192, precision, 132) > 1
