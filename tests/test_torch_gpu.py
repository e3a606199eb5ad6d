"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip without a card.
Run them on the GPU machine with `pytest -m gpu tests/test_torch_gpu.py`.
Whether a card is present is decided in the fixture, never at import, so
that every test worker collects the same tests.
"""

import importlib

import numpy as np
import pytest
import torch

from hexl_tpu_torch import (NTT, FFTLike, _build, dyadic_multiply,
                            eltwise_add_mod,
                            eltwise_cmp_add, eltwise_cmp_sub_mod,
                            eltwise_fma_mod, eltwise_montgomery_form_in,
                            eltwise_mult_mod, eltwise_reduce_mod, key_switch,
                            lr_mat_vec_mult, nt, poly_mult_mod,
                            rns_poly_mult_mod)
from hexl_tpu_torch import poly
from hexl_tpu_torch.eltwise import ops, torch_kernels, torch_kernels32
from hexl_tpu_torch.experimental import cuda_fft, df32, fft_like
from hexl_tpu_torch.limb import to_tensor
from hexl_tpu_torch.ntt import (cuda_ntt, fwd_ntt_mxu, get_mxu_plan, get_plan,
                                hier, inv_ntt_mxu, mxu_ntt, ntt32, torch_ntt)

dyadic_mod = importlib.import_module("hexl_tpu_torch.experimental.dyadic")
ks_mod = importlib.import_module("hexl_tpu_torch.experimental.key_switch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda", 0)


def _rand(rng, shape, bound, dev):
    return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64), dev)


@pytest.mark.parametrize("n,batch", [(2, 1), (16, 3), (16, 401), (1024, 32),
                                     (1024, 401), (4096, 3), (4096, 401),
                                     (16384, 2)])
@pytest.mark.parametrize("q_bits", [30, 61])
def test_ntt_kernels_match_plain(cuda, n, batch, q_bits):
    q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(n + q_bits)
    for imf in (1, 2, 4):
        x = _rand(rng, (batch, n), imf * q, cuda)
        for omf in (1, 4):
            got = cuda_ntt.fwd_ntt(x, plan, imf, omf)
            torch.cuda.synchronize()
            assert torch.equal(got, torch_ntt.fwd_ntt(x, plan, imf, omf))
    for imf in (1, 2):
        x = _rand(rng, (batch, n), imf * q, cuda)
        for omf in (1, 2):
            got = cuda_ntt.inv_ntt(x, plan, imf, omf)
            torch.cuda.synchronize()
            assert torch.equal(got, torch_ntt.inv_ntt(x, plan, imf, omf))


@pytest.mark.parametrize("n,batch", [(64, 3), (4096, 2), (16384, 4)])
def test_poly_and_mult_mod_kernels_match_plain(cuda, n, batch):
    q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(n)
    a, b = _rand(rng, (batch, n), q, cuda), _rand(rng, (batch, n), q, cuda)
    got = poly.poly_mult(a, b, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, poly.poly_mult_plain(a, b, plan))
    for imf in (1, 2, 4):
        a, b = (_rand(rng, (batch, n), imf * q, cuda) for _ in range(2))
        got = ops.mult_mod(a, b, q, imf)
        torch.cuda.synchronize()
        assert torch.equal(got, torch_kernels.mult_mod(a, b, q, imf))


@pytest.mark.parametrize("n,batch", [(1 << 15, 3), (1 << 20, 1)])
@pytest.mark.parametrize("q_bits", [29, 61, 62])
def test_split_kernels_match_plain(cuda, n, batch, q_bits):
    """K5 and K6, each against its plain version (u64 for every modulus,
    and the u32 instantiation for the 29-bit one). q_bits = 62 is the
    largest prime below 2^62, where 4q is just under 2^64."""
    q = (nt.generate_primes(1, 61, False, ntt_size=n)[0] if q_bits == 62
         else nt.generate_primes(1, q_bits, True, ntt_size=n)[0])
    plan = get_plan(n, q)
    rng = np.random.default_rng(n + q_bits)
    blocks = (batch, n // hier.LOCAL_N, hier.LOCAL_N)
    for word in ((64, 32) if q_bits < 30 else (64,)):
        for omf in (1, 4):
            x = _rand(rng, (batch, n), 4 * q, cuda)
            got = hier.cross(x.view(blocks), plan, True, omf, word)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.cross_fwd_plain(x.view(blocks), plan,
                                                         word))
            got = hier.local(x, plan, True, omf, word)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.local_fwd_plain(x, plan, omf, word))
        for omf in (1, 2):
            x = _rand(rng, (batch, n), 2 * q, cuda)
            got = hier.local(x, plan, False, omf, word)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.local_inv_plain(x, plan, word))
            got = hier.cross(x.view(blocks), plan, False, omf, word)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.cross_inv_plain(x.view(blocks), plan,
                                                         omf, word))


@pytest.mark.parametrize("log_n", range(3, 16))
def test_single_word_kernel_matches_plain(cuda, log_n):
    """K7 (the radix walk in u32, one polynomial per CTA) against the
    plain single-word walk at every N from 2^3 to 2^15, ragged batches,
    every IMF/OMF pair it takes, lazy outputs included. Batch 133 is
    more CTAs than an H100 has SMs: the 512-thread form at 2^13 and
    2^14."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    for q_bits in (20, 29):
        q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
        plan = get_plan(n, q)
        for batch in (1, 37, 133):
            for imf in (1, 2, 4):
                x = _rand(rng, (batch, n), imf * q, cuda)
                for omf in (1, 4):
                    got = cuda_ntt.fwd_ntt(x, plan, imf, omf, word=32)
                    torch.cuda.synchronize()
                    assert torch.equal(got, ntt32.fwd_ntt32(x, plan, imf,
                                                            omf))
            for imf in (1, 2):
                x = _rand(rng, (batch, n), imf * q, cuda)
                for omf in (1, 2):
                    got = cuda_ntt.inv_ntt(x, plan, imf, omf, word=32)
                    torch.cuda.synchronize()
                    assert torch.equal(got, ntt32.inv_ntt32(x, plan, imf,
                                                            omf))


def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((torch_ntt, "fwd_ntt"), (torch_ntt, "inv_ntt"),
                      (torch_kernels, "mult_mod"),
                      (poly, "poly_mult_plain")):
        monkeypatch.setattr(mod, name, refuse)
    n = 1024
    q = nt.generate_primes(1, 50, True, ntt_size=n)[0]
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=(4, n), dtype=np.uint64)
    _build.reset_launches()
    engine = NTT(n, q)
    y = engine.forward(x)
    np.testing.assert_array_equal(engine.inverse(y), x)
    poly_mult_mod(x, x, n, q)
    eltwise_mult_mod(x, x, q)
    # At N = 2^10 a product runs K3's one-CTA form (poly.form_for).
    assert dict(_build.launches) == {"K1": 2, "K3.cta": 1, "K4": 1}
    # The packed route: N = 64, where a polynomial alone gives a CTA of
    # less than a warp (cuda_ntt.polys_per_cta).
    n64 = 64
    q64 = nt.generate_primes(1, 50, True, ntt_size=n64)[0]
    small = NTT(n64, q64)
    big = rng.integers(0, q64, size=(4096, n64), dtype=np.uint64)
    np.testing.assert_array_equal(small.inverse(small.forward(big)), big)
    assert _build.launches["K2"] == 2


def test_split_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    """N = 2^15: the public transforms (64-bit and single-word), the
    poly-mult and the RNS product launch K5/K6 (and K4), never a plain
    version."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((torch_ntt, "fwd_stages"), (torch_ntt, "inv_stages"),
                      (torch_ntt, "inv_final"), (torch_kernels, "mult_mod"),
                      (poly, "poly_mult_plain")):
        monkeypatch.setattr(mod, name, refuse)
    n = 1 << 15
    rng = np.random.default_rng(1)
    q, q29 = (nt.generate_primes(1, b, True, ntt_size=n)[0] for b in (50, 29))
    x = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    x29 = rng.integers(0, q29, size=(2, n), dtype=np.uint64)
    _build.reset_launches()
    engine, engine29 = NTT(n, q), NTT(n, q29)
    np.testing.assert_array_equal(engine.inverse(engine.forward(x)), x)
    np.testing.assert_array_equal(engine29.inverse(engine29.forward(x29)),
                                  x29)
    poly_mult_mod(x, x, n, q)
    rns_poly_mult_mod(np.stack([x, x29]), np.stack([x, x29]), n, [q, q29])
    assert dict(_build.launches) == {"K5": 11, "K6": 11, "K7": 2, "K4": 3}


def _u64(rng, lo, hi):
    """A u64 Python int in [lo, hi); hi may be 2^64."""
    return int(rng.integers(lo, hi - 1, dtype=np.uint64, endpoint=True))


def _modulus(q_bits, n=1024):
    """generate_primes gives q in (2^b, 2^(b+1)); "62" is the largest
    prime below 2^62 instead."""
    if q_bits == 62:
        return nt.generate_primes(1, 61, False, ntt_size=n)[0]
    return nt.generate_primes(1, q_bits, True, ntt_size=n)[0]


@pytest.mark.parametrize("q_bits", [20, 29, 49, 60, 61, 62])
def test_eltwise_kernels_match_plain(cuda, q_bits):
    """K4 and K8: every op, in both words where q allows the single word,
    over the IMF/OMF matrix; cmp with bounds on both sides of 2^63 and
    inputs across the whole u64 range."""
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits)
    size = 5000

    def rand(bound):
        return to_tensor(rng.integers(0, bound - 1, size=size,
                                      dtype=np.uint64, endpoint=True), cuda)

    def same(got, want):
        torch.cuda.synchronize()
        assert torch.equal(got, want)

    for word in ((64, 32) if q < ops.SMALL_Q else (64,)):
        plain = torch_kernels32 if word == 32 else torch_kernels
        k32 = word == 32
        a, b, s = rand(q), rand(q), _u64(rng, 0, q)
        same(ops.add_mod(a, b, q, word),
             (plain.add_mod32 if k32 else plain.add_mod)(a, b, q))
        same(ops.add_mod(a, s, q, word),
             (plain.add_mod32 if k32 else plain.add_mod)(a, s, q))
        same(ops.sub_mod(a, b, q, word),
             (plain.sub_mod32 if k32 else plain.sub_mod)(a, b, q))
        same(ops.sub_mod(a, s, q, word),
             (plain.sub_mod32 if k32 else plain.sub_mod)(a, s, q))
        for imf in (1, 2, 4):
            if q >= 1 << 62 or (k32 and imf * q >= 1 << 32):
                continue
            x, y = rand(imf * q), rand(imf * q)
            same(ops.mult_mod(x, y, q, imf, word),
                 (plain.mult_mod32 if k32 else plain.mult_mod)(x, y, q, imf))
        for imf in (1, 2, 4, 8):
            if q >= 1 << 61 or (k32 and imf * q >= 1 << 32):
                continue
            x, z = rand(imf * q), rand(imf * q)
            w = nt.reduce_mod(_u64(rng, 0, imf * q), q, imf)
            wp = nt.barrett_factor(w, word, q)
            fma = (plain.fma_mod32_preconned if k32
                   else plain.fma_mod_preconned)
            for c in (z, None):
                same(ops.fma_mod(x, w, wp, c, q, imf, word),
                     fma(x, w, wp, c, q, imf))
        for imf, omf in ((q, 1), (q, 2), (2, 1), (4, 1), (4, 2), (2, 2)):
            if k32 and imf == q:
                continue
            x = rand(1 << 64) if imf == q else rand(imf * q)
            red = plain.reduce_mod32 if k32 else plain.reduce_mod
            same(ops.reduce_mod(x, q, imf, omf, word), red(x, q, imf, omf))
    full = rand(1 << 64)
    for cmp in torch_kernels.CMP_NAMES:
        for bound in (_u64(rng, 0, 1 << 63), _u64(rng, 1 << 63, 1 << 64)):
            f = full.clone()
            f[:7] = int(np.uint64(bound).view(np.int64))
            diff = _u64(rng, 1, 1 << 64)
            same(ops.cmp_add(f, cmp, bound, diff),
                 torch_kernels.cmp_add(f, cmp, bound, diff))
            diff = _u64(rng, 1, q)
            same(ops.cmp_sub_mod(f, q, cmp, bound, diff),
                 torch_kernels.cmp_sub_mod(f, q, cmp, bound, diff))
    if q < 1 << 62:
        a, b = rand(q), rand(q)
        same(ops.montgomery_form_in(a, q),
             torch_kernels.montgomery_form_in(a, q))
        same(ops.montgomery_form_out(a, q),
             torch_kernels.montgomery_form_out(a, q))
        same(ops.montgomery_mult_reduce(a, b, q),
             torch_kernels.montgomery_mult_reduce(a, b, q))


@pytest.mark.parametrize("weights", [1, 4])
def test_dyadic_kernel_matches_plain(cuda, weights):
    """K9 over moduli of mixed bit lengths (one launch, per-row shifts),
    up to the largest prime below 2^62."""
    moduli = [_modulus(b) for b in (20, 40, 50, 60, 62)]
    rng = np.random.default_rng(weights)
    n = 4099

    def cipher():
        return torch.stack([torch.stack([
            torch.stack([to_tensor(rng.integers(0, q, n, dtype=np.uint64),
                                   cuda) for q in moduli])
            for _ in range(2)]) for _ in range(weights)])

    x, y = cipher(), cipher()
    got = dyadic_mod.dyadic(x, y, moduli)
    torch.cuda.synchronize()
    want = dyadic_mod.dyadic_plain(
        x, y, dyadic_mod.row_constants(tuple(moduli), cuda))
    assert torch.equal(got, want)


def _key_switch_inputs(rng, n, bits, kc, dev):
    ds = len(bits) - 1
    moduli = []
    for b in bits:
        moduli.append(next(p for p in nt.generate_primes(4, b, True,
                                                         ntt_size=n)
                           if p not in moduli))
    qk = moduli[-1]

    def rows(count):
        return torch.stack([to_tensor(rng.integers(0, q, n, dtype=np.uint64),
                                      dev) for q in moduli[:count]])

    t = rows(ds)
    keys = torch.stack([torch.stack([rows(ds + 1) for _ in range(kc)])
                        for _ in range(ds)])
    msf = [nt.inverse_mod(qk % q, q) for q in moduli[:ds]]
    result = torch.stack([rows(ds) for _ in range(kc)])
    return result, t, keys, moduli, msf


@pytest.mark.parametrize("n,bits,kc", [(64, (40, 41, 45), 2),
                                       (1 << 14, (61, 50, 60, 45), 3),
                                       (1 << 15, (49,) * 4, 2)])
def test_key_switch_kernels_match_plain(cuda, n, bits, kc):
    """K10 and K11 against their plain versions, and the whole key switch
    (K1/K5/K6, K8, K10, K11) against the plain pipeline."""
    rng = np.random.default_rng(n)
    result, t, keys, moduli, msf = _key_switch_inputs(rng, n, bits, kc,
                                                      cuda)
    ds = len(bits) - 1
    c = ks_mod.constants(tuple(moduli), tuple(msf), ds, cuda)
    tq = torch.stack([to_tensor(rng.integers(0, 4 * q, (ds, n),
                                             dtype=np.uint64), cuda)
                      for q in moduli[:ds] + moduli[-1:]])
    got = ks_mod.mac_flush(tq, keys, c, ds, kc, ds + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_mod.mac_flush_plain(tq, keys, c.mac, ds, kc,
                                                   ds + 1))
    x = to_tensor(rng.integers(0, 2 * moduli[-1], (kc, n), dtype=np.uint64),
                  cuda)
    got = ks_mod.spread(x, c)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_mod.spread_plain(x, c))
    tntt = torch.stack([to_tensor(rng.integers(0, 4 * q, (kc, n),
                                               dtype=np.uint64), cuda)
                        for q in moduli[:ds]])
    tpp = ks_mod.mac_flush(tq, keys, c, ds, kc, ds + 1)
    got = ks_mod.fold(result, tpp, tntt, c)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_mod.fold_plain(result, tpp, tntt, c))
    before = result.clone()
    got = key_switch(result, t, n, ds, ds + 1, ds + 1, kc, moduli, keys, msf)
    torch.cuda.synchronize()
    want = ks_mod.key_switch_plain(result, t, n, ds, ds + 1, ds + 1, kc,
                                   moduli, keys, msf)
    assert torch.equal(got, want)
    assert torch.equal(result, before)


def test_slice3_entry_points_never_take_the_plain_path(cuda, monkeypatch):
    """The eltwise family and the composites on CUDA tensors launch their
    kernels (single word where the JAX routing picks it), never a plain
    version."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod in (torch_kernels, torch_kernels32):
        for name in dir(mod):
            if callable(getattr(mod, name)) and not name.startswith("_") \
                    and name not in ("cmp_code", "mult_constants32"):
                monkeypatch.setattr(mod, name, refuse)
    for name in ("dyadic_plain", "mac_flush_plain", "spread_plain",
                 "fold_plain"):
        monkeypatch.setattr(dyadic_mod if name == "dyadic_plain" else ks_mod,
                            name, refuse)
    for name in ("fwd_stages", "inv_stages", "inv_final"):
        monkeypatch.setattr(torch_ntt, name, refuse)
    rng = np.random.default_rng(2)
    q60, q29 = _modulus(60), _modulus(29)
    a60 = to_tensor(rng.integers(0, q60, 4096, dtype=np.uint64), cuda)
    a29 = to_tensor(rng.integers(0, q29, 4096, dtype=np.uint64), cuda)
    _build.reset_launches()
    eltwise_add_mod(a60, a60, q60)
    eltwise_add_mod(a29, 5, q29)
    eltwise_mult_mod(a29, a29, q29, 4)
    eltwise_fma_mod(a60, 7, a60, q60, 8)
    eltwise_fma_mod(a29, 7, None, q29, 1)
    eltwise_reduce_mod(a60, q60, q60, 2)
    eltwise_reduce_mod(a29, q29, 4, 1)
    eltwise_cmp_add(a60, "nlt", 1 << 63, 3)
    eltwise_cmp_sub_mod(a60, q60, "le", q60 // 2, 3)
    eltwise_montgomery_form_in(a60, q60)
    assert dict(_build.launches) == {
        "K8.add_sub": 1, "K8.add_sub.u32": 1, "K8.mult.u32": 1, "K8.fma": 1,
        "K8.fma.u32": 1, "K8.reduce": 1, "K8.reduce.u32": 1, "K8.cmp": 2,
        "K8.mont": 1}
    n, bits = 1 << 15, (49, 49, 49)
    result, t, keys, moduli, msf = _key_switch_inputs(rng, n, bits, 2, cuda)
    x = torch.stack([t, t])
    _build.reset_launches()
    dyadic_multiply(x, x, moduli[:2])
    lr_mat_vec_mult(torch.stack([x, x]), torch.stack([x, x]), moduli[:2])
    key_switch(result, t, n, 2, 3, 3, 2, moduli, keys, msf)
    # ds = 2 at 2^15: 2 + 3 + 1 + 2 inverse/forward transforms of two
    # passes (K5, K6) each, one K8 reduce per row, K10, K11 twice.
    assert dict(_build.launches) == {"K9": 2, "K5": 8, "K6": 8,
                                     "K8.reduce": 3, "K10": 1, "K11": 2}


def _fft_value(rng, shape, precision, dev):
    z = torch.from_numpy(rng.normal(size=shape) + 1j * rng.normal(size=shape))
    if precision == "double_float":
        return df32.cdf_from_complex128(z, dev)
    return z.to(dev, fft_like._CTYPE[precision])


def _same_value(got, want, precision):
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(
        cuda_fft.planes(got, precision), cuda_fft.planes(want, precision)))


def _tiny_block(v, table, scalar, precision, forward):
    """K12 at n <= 8, which the wrappers refuse (FFTLike takes n > 8),
    through its C entry with one transform per CTA: the radix walk with
    R = 2 (n = 2, 4) or one group of 8."""
    out = cuda_fft.empty_like(v, precision)
    first = cuda_fft.planes(v, precision)[0]
    n = first.shape[-1]
    fn = _build.function("fft", "hexl_fft_block", cuda_fft._BLOCK_ARGS)
    _build.launch_on(cuda_fft._device_of(v, precision), "K12", fn,
                     cuda_fft._CODE[precision],
                     *cuda_fft.pointers(v, precision),
                     *cuda_fft.pointers(out, precision),
                     *cuda_fft.pointers(table, precision),
                     *cuda_fft._scalar_args(scalar, precision), int(forward),
                     nt.log2_exact(n), 0, first.numel() // n, 1)
    return out


def _tiny_plain(v, table, scalar, precision, forward):
    n = cuda_fft.planes(v, precision)[0].shape[-1]
    walk = fft_like.fwd_walk if forward else fft_like.inv_walk
    return cuda_fft.value(walk(cuda_fft.planes(v, precision),
                               cuda_fft.planes(table, precision), n, scalar,
                               fft_like.arith(precision)), precision)


def _tiny_tables(n, scalar, precision, dev):
    """(tables, forward scale, inverse scale) of degree n in the
    precision's form, as FFTLike makes them for n > 8."""
    tabs = [torch.from_numpy(t) for t in fft_like.build_tables(n)]
    if precision == "double_float":
        tabs = [df32.cdf_from_complex128(t, dev) for t in tabs]
    else:
        tabs = [t.to(dev, fft_like._CTYPE[precision]) for t in tabs]
    if scalar is None:
        return tabs, None, None
    scales = (1.0 / scalar, scalar / n)
    if precision == "double_float":
        scales = tuple(df32.df_from_f64(np.float64(s)) for s in scales)
    elif precision == "single":
        scales = tuple(float(np.float32(s)) for s in scales)
    return tabs, scales[0], scales[1]


@pytest.mark.parametrize("precision", ["f64", "single", "double_float"])
@pytest.mark.parametrize("log_n", range(1, 18))
def test_fft_kernels_match_plain(cuda, precision, log_n):
    """K12 (and K13 above 2^13) bit-exact against the plain walk on the
    card at every n from 2 to 2^17, with and without a scalar: one
    transform per CTA (the radix walk) at batches 1 and 3; batch 300 up to
    2^12, several per CTA (the stage walk) below cuda_fft.PACK_BELOW; above
    2^13 each pass alone too. n <= 8 goes through K12's C entry (FFTLike
    takes n > 8)."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    if n <= cuda_fft.BLOCK_N:
        batches = (1, 3, 300) if n <= 1 << 12 else (1, 3)
    else:
        batches = (2,)
    for scalar in (None, 2.0 ** 40):
        if n <= 8:
            tables, sf, si = _tiny_tables(n, scalar, precision, cuda)
        else:
            fft = FFTLike(n, scalar, precision=precision, device=cuda)
            tables = fft.tables(cuda)
            sf, si = fft.fused_scale(True), fft.fused_scale(False)
        for batch in batches:
            v = _fft_value(rng, (batch, n), precision, cuda)
            for forward in (True, False):
                s = sf if forward else si
                tab = tables[0 if forward else 1]
                if n <= 8:
                    assert _same_value(
                        _tiny_block(v, tab, s, precision, forward),
                        _tiny_plain(v, tab, s, precision, forward), precision)
                    continue
                fn = cuda_fft.forward if forward else cuda_fft.inverse
                assert _same_value(fn(v, tab, s, precision),
                                   cuda_fft.walk_plain(v, tab, s, precision,
                                                       forward), precision)
                if n > cuda_fft.BLOCK_N:
                    assert _same_value(
                        cuda_fft.cross(v, tab, s, precision, forward),
                        cuda_fft.cross_plain(v, tab, s, precision, forward),
                        precision)
                    assert _same_value(
                        cuda_fft.block(v, tab, s, precision, forward),
                        cuda_fft.block_plain(v, tab, s, precision, forward),
                        precision)


@pytest.mark.parametrize("precision", ["auto", "single", "double_float"])
@pytest.mark.parametrize("n", [1024, 1 << 14])
def test_fft_lazy_conjugate_on_card(cuda, precision, n):
    """z.conj() on the card transforms as its conjugate: the kernels get
    the resolved memory, bit-equal to the plain walk of conj(z)."""
    fft = FFTLike(n, 2.0 ** 40, precision=precision, device=cuda)
    z = torch.from_numpy(np.random.default_rng(n).normal(size=(2, n, 2)))
    z = torch.view_as_complex(z).to(cuda)
    lazy, eager = z.conj(), z.conj().resolve_conj()
    assert lazy.is_conj()
    tables = fft.tables(cuda)
    for forward in (True, False):
        got = (fft.forward if forward else fft.inverse)(lazy)
        v = (df32.cdf_from_complex128(eager) if fft.precision == "double_float"
             else eager.to(fft_like._CTYPE[fft.precision]))
        want = cuda_fft.walk_plain(v, tables[0 if forward else 1],
                                   fft.fused_scale(forward), fft.precision,
                                   forward)
        if fft.precision == "double_float":
            want = df32.cdf_to_complex128(want)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,bits", [(256, 29), (1024, 52), (1 << 14, 60),
                                     (1 << 17, 62)])
def test_mxu_folds_match_plain(cuda, n, bits):
    """K14 and K15 against the plain folds on the same int32 planes, over
    the IMF/OMF matrix; the OMF 1 outputs equal the NTT's."""
    q = _modulus(bits, n)
    plan = get_mxu_plan(n, q)
    rng = np.random.default_rng(n + bits)

    def checked(kernel, plain):
        def fold(planes, *args):
            got = kernel(planes, *args)
            torch.cuda.synchronize()
            assert torch.equal(got, plain(planes, *args))
            return got
        return fold

    boundary = checked(mxu_ntt.fold_twiddle, mxu_ntt.fold_twiddle_plain)
    final = checked(mxu_ntt.fold_final, mxu_ntt.fold_final_plain)
    for forward, imfs, omfs in ((True, (1, 2, 4), (1, 4)),
                                (False, (1, 2), (1, 2))):
        for imf in imfs:
            if imf * q >= 1 << 64:
                continue
            x = _rand(rng, (2, n), imf * q, cuda)
            for omf in omfs:
                mxu_ntt._passes(x, plan, forward, omf, boundary, final)
    x = _rand(rng, (3, n), q, cuda)
    ntt = NTT(n, q)
    assert torch.equal(fwd_ntt_mxu(x, plan), ntt.forward(x))
    assert torch.equal(inv_ntt_mxu(x, plan), ntt.inverse(x))


def test_slice4_entry_points_never_take_the_plain_path(cuda, monkeypatch):
    """FFTLike in every precision and the MXU transforms on CUDA tensors
    launch K12-K15, never a plain walk or fold."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("fwd_stages", "inv_stages", "inv_final"):
        monkeypatch.setattr(fft_like, name, refuse)
    for name in ("fold_twiddle_plain", "fold_final_plain"):
        monkeypatch.setattr(mxu_ntt, name, refuse)
    rng = np.random.default_rng(4)
    z = rng.normal(size=(2, 1 << 14)) + 1j * rng.normal(size=(2, 1 << 14))
    _build.reset_launches()
    for precision in ("auto", "single", "double_float"):
        fft = FFTLike(1 << 14, 2.0 ** 40, precision=precision)
        back = fft.forward(fft.inverse(z))
        assert np.abs(back - z).max() < (1e-3 if precision == "single"
                                         else 1e-9)
    q = _modulus(60, 1 << 14)
    x = rng.integers(0, q, size=(2, 1 << 14), dtype=np.uint64)
    plan = get_mxu_plan(1 << 14, q)
    np.testing.assert_array_equal(inv_ntt_mxu(fwd_ntt_mxu(x, plan), plan), x)
    assert dict(_build.launches) == {
        "K12.f64": 2, "K13.f64": 2, "K12.f32": 2, "K13.f32": 2,
        "K12.df": 2, "K13.df": 2, "K14": 2, "K15": 2}


# -- the parallel layer -------------------------------------------------------

@pytest.mark.parametrize("d,log_n,q_bits", [(2, 12, 61), (4, 15, 30),
                                            (8, 14, 50), (16, 17, 60),
                                            (128, 15, 50), (256, 17, 61)])
def test_column_stride_cross_kernel_matches_plain(cuda, d, log_n, q_bits):
    """K5 on DistNTT's exchanged (batch, D, lc) blocks, lc = N/D^2 (and a
    slice of the chunk axis, as overlap_slices cuts it), forward and
    inverse at both OMFs; above 64 rows, its two launches."""
    n = 1 << log_n
    q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(n + d)
    lc = n // (d * d)
    for batch, width in ((1, lc), (3, lc), (2, max(1, lc // 4))):
        x = _rand(rng, (batch, d, width), 4 * q, cuda)
        got = hier.cross(x, plan, True)
        torch.cuda.synchronize()
        assert torch.equal(got, hier.cross_fwd_plain(x, plan))
        x = _rand(rng, (batch, d, width), 2 * q, cuda)
        for omf in (1, 2):
            got = hier.cross(x, plan, False, omf)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.cross_inv_plain(x, plan, omf))


@pytest.mark.parametrize("d,log_n", [(4, 12), (8, 14), (2, 15), (4, 17),
                                     (2, 17)])
def test_shard_base_local_kernel_matches_plain(cuda, d, log_n):
    """K6 with a shard base at every position (and, for a shard above
    2^14, K5 on its intra-shard stages), forward at both OMFs and
    inverse."""
    from hexl_tpu_torch.ntt import shard
    n = 1 << log_n
    q = nt.generate_primes(1, 61, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(n + d)
    for r in range(d):
        x = _rand(rng, (3, n // d), 4 * q, cuda)
        for omf in (1, 4):
            got = shard.local(x, plan, r, d, True, omf)
            torch.cuda.synchronize()
            assert torch.equal(got, shard.local_fwd_plain(x, plan, r, d, omf))
        x = _rand(rng, (3, n // d), 2 * q, cuda)
        got = shard.local(x, plan, r, d, False)
        torch.cuda.synchronize()
        assert torch.equal(got, shard.local_inv_plain(x, plan, r, d))


@pytest.mark.parametrize("log_n,q_bits", [(10, 30), (14, 61), (17, 50)])
def test_stage_kernel_matches_plain(cuda, log_n, q_bits):
    """K16 at every stage, the fused final stage at OMF 1 and 2 (4 and 1
    forward), and a whole transform of single-stage launches."""
    from hexl_tpu_torch.parallel import pipeline
    n = 1 << log_n
    q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(log_n)
    for k in range(log_n):
        last = k == log_n - 1
        for forward, bound, omfs in ((True, 4 * q, (1, 4) if last else (4,)),
                                     (False, 2 * q, (1, 2) if last else (2,))):
            x = _rand(rng, (2, n), bound, cuda)
            for omf in omfs:
                got = pipeline.stages(x, plan, forward, k, k + 1, omf)
                torch.cuda.synchronize()
                assert torch.equal(got, pipeline.stages_plain(
                    x, plan, forward, k, k + 1, omf))
    x = _rand(rng, (2, n), q, cuda)
    assert torch.equal(pipeline.stages(x, plan, True, 0, log_n, 1),
                       torch_ntt.fwd_ntt(x, plan))
    assert torch.equal(pipeline.stages(x, plan, False, 0, log_n, 1),
                       torch_ntt.inv_ntt(x, plan))


def test_parallel_layer_on_a_one_card_mesh(cuda, monkeypatch):
    """DistNTT, its product, PipelineNTT and the sharded composites on
    meshes of cuda:0 positions equal the single-device calls, through
    K4-K6, K8-K11 and K16 only (the plain walks refuse)."""
    from hexl_tpu_torch.parallel import (DistNTT, PipelineNTT,
                                         dist_dyadic_multiply,
                                         dist_key_switch, dist_rns_poly_mult,
                                         make_mesh, make_pipeline_mesh)
    n = 1 << 15
    rng = np.random.default_rng(5)
    q = nt.generate_primes(1, 50, True, ntt_size=n)[0]
    x = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    engine = NTT(n, q)
    want_fwd, want_prod = engine.forward(x, 1, 4), poly_mult_mod(x, x, n, q)
    q2 = nt.generate_primes(2, 50, True, ntt_size=n)
    xs = rng.integers(0, min(q2), size=(2, 2, n), dtype=np.uint64)
    want_rns = rns_poly_mult_mod(xs, xs, n, q2)
    q12 = nt.generate_primes(1, 60, True, ntt_size=1 << 12)[0]
    xp = rng.integers(0, q12, size=(5, 2, 1 << 12), dtype=np.uint64)
    want_pipe = NTT(1 << 12, q12).forward(xp)
    result, t, keys, moduli, msf = _key_switch_inputs(rng, 1 << 14,
                                                      (49, 49, 49, 49), 2,
                                                      cuda)
    want_ks = key_switch(result, t, 1 << 14, 3, 4, 4, 2, moduli, keys, msf)
    c = torch.stack([t[:2], t[:2]])
    want_dy = dyadic_multiply(c, c, moduli[:2])

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("fwd_stages", "inv_stages", "inv_final"):
        monkeypatch.setattr(torch_ntt, name, refuse)
    for name in ("dyadic_plain", "mac_flush_plain", "spread_plain",
                 "fold_plain"):
        monkeypatch.setattr(dyadic_mod if name == "dyadic_plain" else ks_mod,
                            name, refuse)
    monkeypatch.setattr(torch_kernels, "mult_mod", refuse)
    _build.reset_launches()
    for d, nb in ((4, 2), (8, 1), (2, 1), (128, 1)):
        mesh = make_mesh(d, nb, ["cuda:0"] * (d * nb))
        dist = DistNTT(n, q, mesh, overlap_slices=2)
        np.testing.assert_array_equal(dist.forward(x, 1, 4), want_fwd)
        np.testing.assert_array_equal(dist.inverse(want_fwd % np.uint64(q)),
                                      x)
        np.testing.assert_array_equal(dist.poly_mult(x, x), want_prod)
        np.testing.assert_array_equal(dist_rns_poly_mult(xs, xs, n, q2, mesh),
                                      want_rns)
    ring = make_pipeline_mesh(8, ["cuda:0"] * 8)
    np.testing.assert_array_equal(
        PipelineNTT(1 << 12, q12, ring).forward(xp), want_pipe)
    mesh = make_mesh(4, 2, ["cuda:0"] * 8)
    got = dist_key_switch(result, t, 1 << 14, 3, 4, 4, 2, moduli, keys, msf,
                          mesh)
    torch.cuda.synchronize()
    assert torch.equal(got, want_ks)
    assert torch.equal(dist_dyadic_multiply(c, c, moduli[:2], mesh), want_dy)
    launched = dict(_build.launches)
    assert all(launched.get(k, 0) > 0 for k in
               ("K4", "K5", "K6", "K8.reduce", "K9", "K10", "K11",
                "K16")), launched


# -- the approximate-butterfly schemes and the chains (K17, K18) ------------

def _lean_schemes(q):
    """Every lean scheme q allows."""
    return [s for s, bound in (("lean16", torch_ntt.LEAN16_MAX_Q),
                               ("lean8", torch_ntt.LEAN_APPROX_MAX_Q))
            if q < bound]


@pytest.mark.parametrize("n,batch", [(2, 1), (16, 401), (1024, 401),
                                     (4096, 3), (8192, 2), (16384, 2)])
@pytest.mark.parametrize("q_bits", [49, 59, 60])
def test_lean_ntt_kernels_match_plain(cuda, n, batch, q_bits):
    q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(n + q_bits)
    for scheme in _lean_schemes(q):
        for imf in (1, 2, 4):
            x = _rand(rng, (batch, n), imf * q, cuda)
            for omf in (1, 4):
                got = cuda_ntt.fwd_ntt(x, plan, imf, omf, 64, scheme)
                torch.cuda.synchronize()
                assert torch.equal(got, torch_ntt.fwd_ntt(x, plan, imf, omf,
                                                          64, scheme))
                if omf == 1:
                    assert torch.equal(got, cuda_ntt.fwd_ntt(x, plan, imf, 1))
        for imf in (1, 2):
            x = _rand(rng, (batch, n), imf * q, cuda)
            for omf in (1, 2):
                got = cuda_ntt.inv_ntt(x, plan, imf, omf, 64, scheme)
                torch.cuda.synchronize()
                assert torch.equal(got, torch_ntt.inv_ntt(x, plan, imf, omf,
                                                          64, scheme))


@pytest.mark.parametrize("n,batch", [(1 << 15, 3), (1 << 20, 1)])
@pytest.mark.parametrize("q_bits", [49, 59, 60])
def test_lean_split_kernels_match_plain(cuda, n, batch, q_bits):
    q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(n + q_bits)
    blocks = (batch, n // hier.LOCAL_N, hier.LOCAL_N)
    for scheme in _lean_schemes(q):
        x = _rand(rng, blocks, 4 * q, cuda)
        c = hier.cross(x, plan, True, 1, 64, scheme)
        torch.cuda.synchronize()
        assert torch.equal(c, hier.cross_fwd_plain(x, plan, 64, scheme))
        c = c.view(batch, n)
        for omf in (1, 4):
            got = hier.local(c, plan, True, omf, 64, scheme)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.local_fwd_plain(c, plan, omf, 64,
                                                         scheme))
        x = _rand(rng, (batch, n), 2 * q, cuda)
        loc = hier.local(x, plan, False, 1, 64, scheme)
        torch.cuda.synchronize()
        assert torch.equal(loc, hier.local_inv_plain(x, plan, 64, scheme))
        for omf in (1, 2):
            got = hier.cross(loc.view(blocks), plan, False, omf, 64, scheme)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.cross_inv_plain(loc.view(blocks),
                                                         plan, omf, 64,
                                                         scheme))


def test_public_lean_regime_goes_through_the_kernels(cuda, monkeypatch):
    """With the regime forced on, NTT runs the lean instantiations: equal
    to the plain lean walk, and to the exact outputs at OMF 1."""
    from hexl_tpu_torch import config
    n = 1 << 14
    for q_bits, scheme in ((60, "lean8"), (59, "lean16")):
        q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
        engine, plan = NTT(n, q), get_plan(n, q)
        x = _rand(np.random.default_rng(q_bits), (4, n), q, cuda)
        exact = engine.forward(x)
        monkeypatch.setattr(config, "approx_butterflies", lambda d: True)
        _build.reset_launches()
        lazy = engine.forward(x, 1, 4)
        y = engine.forward(x)
        back = engine.inverse(y)
        torch.cuda.synchronize()
        assert _build.launches[f"K1.{scheme}"] == 3
        assert torch.equal(lazy, torch_ntt.fwd_ntt(x, plan, 1, 4, 64, scheme))
        assert torch.equal(y, exact) and torch.equal(back, x)
        monkeypatch.setattr(config, "approx_butterflies", lambda d: False)


# -- the radix walk of K1 and K6 ---------------------------------------------

def _check_pair(x_fwd, x_inv, plan, scheme, word=64):
    for imf, x in x_fwd:
        for omf in (1, 4):
            got = cuda_ntt.fwd_ntt(x, plan, imf, omf, word, scheme)
            torch.cuda.synchronize()
            assert torch.equal(got, torch_ntt.fwd_ntt(x, plan, imf, omf, word,
                                                      scheme))
    for imf, x in x_inv:
        for omf in (1, 2):
            got = cuda_ntt.inv_ntt(x, plan, imf, omf, word, scheme)
            torch.cuda.synchronize()
            assert torch.equal(got, torch_ntt.inv_ntt(x, plan, imf, omf, word,
                                                      scheme))


@pytest.mark.parametrize("log_n", range(1, 15))
def test_radix_walk_at_every_degree(cuda, log_n):
    """K1 (one polynomial per CTA) at every N from 2 to 2^14, batches 1
    and 3: exact at 30 and 61 bits, and every lean scheme of a 59-bit q."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    for q_bits in (30, 59, 61):
        q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
        plan = get_plan(n, q)
        for scheme in ["exact"] + (_lean_schemes(q) if q_bits == 59 else []):
            for batch in (1, 3):
                _check_pair([(imf, _rand(rng, (batch, n), imf * q, cuda))
                             for imf in (1, 2, 4)],
                            [(imf, _rand(rng, (batch, n), imf * q, cuda))
                             for imf in (1, 2)], plan, scheme)


@pytest.mark.parametrize("log_d", range(1, 7))
def test_radix_local_pass_at_every_shard_count(cuda, log_d):
    """K6 on the 2^log_d shards of N = 2^(14 + log_d): u64 exact and lean8
    at 60 bits, lean16 at 50, the u32 form at 29."""
    n = 1 << (14 + log_d)
    rng = np.random.default_rng(100 + log_d)
    for q_bits, word, scheme in ((60, 64, "exact"), (60, 64, "lean8"),
                                 (50, 64, "lean16"), (29, 32, "exact")):
        q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
        plan = get_plan(n, q)
        x = _rand(rng, (2, n), 4 * q, cuda)
        for omf in (1, 4):
            got = hier.local(x, plan, True, omf, word, scheme)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.local_fwd_plain(x, plan, omf, word,
                                                         scheme))
        x = _rand(rng, (2, n), 2 * q, cuda)
        got = hier.local(x, plan, False, 1, word, scheme)
        torch.cuda.synchronize()
        assert torch.equal(got, hier.local_inv_plain(x, plan, word, scheme))


@pytest.mark.parametrize("log_n", [11, 12, 13, 14])
def test_radix_shard_base_and_period(cuda, log_n):
    """K6 launched with a shard base and a period: chunk c is shard
    base + (c mod 2^log_sub) of 2^log_d, on 5 chunks, in both words and
    the lean schemes."""
    n = 1 << log_n
    rng = np.random.default_rng(200 + log_n)
    for (log_d, base, log_sub), q_bits in zip(
            ((2, 1, 1), (4, 8, 3), (20 - log_n, 5, 2)), (29, 50, 60)):
        q = nt.generate_primes(1, q_bits, True, ntt_size=n << log_d)[0]
        plan = get_plan(n << log_d, q)
        forms = [(64, "exact")] + [(32, "exact")] * (q < 1 << 30) + [
            (64, s) for s in _lean_schemes(q)]
        for word, scheme in forms:
            args = (log_n, log_d, base, log_sub, word, scheme)
            x = _rand(rng, (5, n), 4 * q, cuda)
            for omf in (1, 4):
                got = hier.local_launch(x, plan, True, omf, *args)
                torch.cuda.synchronize()
                assert torch.equal(got, hier.local_launch_plain(
                    x, plan, True, omf, *args))
            x = _rand(rng, (5, n), 2 * q, cuda)
            got = hier.local_launch(x, plan, False, 1, *args)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.local_launch_plain(x, plan, False, 1,
                                                            *args))


@pytest.mark.parametrize("scheme", ["lean16", "exact"])
def test_ntt_chain_kernel_matches_plain(cuda, scheme):
    from hexl_tpu_torch.ntt import chain
    x, y = chain.probe_inputs(np.random.default_rng(17), cuda, 1024, 128)
    got = chain.chain(x, y, chain.PROBE_W, chain.PROBE_Q, chain.REPS, scheme)
    torch.cuda.synchronize()
    want = chain.chain_plain(x, y, chain.PROBE_W, chain.PROBE_Q, chain.REPS,
                             scheme)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("precision", ["double_float", "f64", "single"])
def test_df_chain_kernel_matches_plain(cuda, precision):
    from hexl_tpu_torch.experimental import df_chain
    rng = np.random.default_rng(18)
    x, y = (_fft_value(rng, (1024, 128), precision, cuda) for _ in range(2))
    w, s = df_chain.twiddle(precision, cuda), df_chain.shrink(precision)
    got = df_chain.chain(x, y, w, s, precision)
    torch.cuda.synchronize()
    want = df_chain.chain_plain(x, y, w, s, precision)
    for g, v in zip(got, want):
        assert _same_value(g, v, precision)


def test_new_instantiations_do_not_spill(cuda):
    """The lean instantiations of K5, the chain kernels, every radix walk
    of K1/K6/K7, K2's packed walk, K3's kernels and K12's radix walk, from
    the -Xptxas -v report of the build."""
    import re
    res = _build.kernel_resources(_build.build_all()["log"])
    new = {k: v for k, v in res.items()
           if "chain_kernel" in k or re.search(r"kernelIyLi[12]E", k)
           or re.search(r"radix_(packed_)?(fwd|inv)_kernel", k)
           or re.search(r"poly_\w+_kernel", k)}
    radix = [k for k in new if "radix_" in k]
    assert len(radix) == ((3 + 6) * 7 + (1 + 2) * 10 + 2 * 3 * 2
                          + 2 * (6 + 6 + 3)), radix
    k3 = [k for k in new if "poly_" in k]
    assert len(k3) == 3 + 6, k3
    assert len(new) >= 2 * 6 * 3 + 2 + 3 + len(radix) + len(k3)
    spills = {k: v for k, v in new.items() if v[2] or v[3]}
    assert not spills, spills


@pytest.mark.parametrize("log_n", range(1, 15))
def test_poly_kernel_every_degree_and_form(cuda, log_n, monkeypatch):
    """K3 in every form it takes at N = 2^log_n (the cluster at
    2^12-2^14, the one-CTA form up to 2^13, each forced in place of
    form_for's pick), at batches 1, 2, 64 and 133, against the plain
    chain; the default form is form_for's and launches once."""
    n = 1 << log_n
    q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(300 + log_n)
    for batch in (1, 2, 64, 133):
        a, b = (_rand(rng, (batch, n), q, cuda) for _ in range(2))
        want = poly.poly_mult_plain(a, b, plan)
        rule = poly.form_for
        for form in poly.forms_of(n):
            monkeypatch.setattr(poly, "form_for", lambda *args, f=form: f)
            _build.reset_launches()
            got = poly.poly_mult(a, b, plan)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {poly.FORMS[form]: 1}
            assert torch.equal(got, want), (form, batch)
        monkeypatch.setattr(poly, "form_for", rule)
        _build.reset_launches()
        got = poly.poly_mult(a, b, plan)
        torch.cuda.synchronize()
        form = poly.form_for(n, batch, cuda_ntt.sm_count(cuda))
        assert dict(_build.launches) == {poly.FORMS[form]: 1}
        assert torch.equal(got, want)


@pytest.mark.parametrize("log_n", range(1, 13))
def test_packed_kernel_every_p(cuda, log_n, monkeypatch):
    """K2 at N = 2^log_n with P forced to every power of two it takes, on
    2P + 1 polynomials (a ragged last CTA), in every scheme, and through
    the rule at the batches 2^k and 2^k + 1 up to 2^8 where it packs."""
    n = 1 << log_n
    q = nt.generate_primes(1, 49, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(400 + log_n)
    runs = [(batch, "exact") for k in range(1, 9) for batch in
            (1 << k, (1 << k) + 1)
            if cuda_ntt.polys_per_cta(n, batch) > 1]
    p = 2
    while p <= cuda_ntt.max_polys_per_cta(n):
        runs += [(2 * p + 1, s, p) for s in torch_ntt.SCHEMES]
        p *= 2
    rule = cuda_ntt.polys_per_cta
    for batch, scheme, *forced in runs:
        monkeypatch.setattr(cuda_ntt, "polys_per_cta",
                            (lambda *a, p=forced[0]: p) if forced else rule)
        _build.reset_launches()
        _check_pair([(imf, _rand(rng, (batch, n), imf * q, cuda))
                     for imf in (1, 2, 4)],
                    [(imf, _rand(rng, (batch, n), imf * q, cuda))
                     for imf in (1, 2)], plan, scheme)
        assert set(_build.launches) == {hier.kernel_name("K2", 64, scheme)}
