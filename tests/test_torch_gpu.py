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

import chip_smoke
from hexl_tpu_torch import (NTT, FFTLike, RnsNTT, _build,
                            dyadic_multiply,
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
                                hier, inv_ntt_mxu, mxu_ntt, ntt32, rns,
                                torch_ntt)
import ks_cases

dyadic_mod = importlib.import_module("hexl_tpu_torch.experimental.dyadic")
ks_mod = importlib.import_module("hexl_tpu_torch.experimental.key_switch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda", 0)


@pytest.fixture
def one_cta(monkeypatch):
    """The cluster form's rule kept at C = 1, for the tests of the one-CTA
    kernels (K1, K6 and their stacked forms) at grids under a wave, where
    `rns.cluster_for` would pick clusters."""
    monkeypatch.setattr(rns, "cluster_for", lambda *args: 1)


def _routed(dev, n, rows, batch, stacked=False):
    """{kernel: 1}: the kernels of one 64-bit exact transform of (rows,
    batch, n) under the cluster form's rule, K1 (.rns) or K1.rns.cl up to
    2^14, K5 (.rns) and K6 (.rns) or K6.rns.cl above."""
    shards = max(1, n >> 14)
    log_n = min(n.bit_length() - 1, 14)
    clustered = n >= 1 << 12 and rns.cluster_for(
        log_n, rows * batch * shards, cuda_ntt.sm_count(dev), dev) > 1
    sfx = ".rns" if stacked else ""
    if n <= 1 << 14:
        return {"K1.rns.cl" if clustered else "K1" + sfx: 1}
    return {"K5" + sfx: 1, "K6.rns.cl" if clustered else "K6" + sfx: 1}


def _launches(*parts):
    """The sum of {kernel: count} parts, each (counts, times)."""
    out = {}
    for counts, times in parts:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v * times
    return out


def _rand(rng, shape, bound, dev):
    return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64), dev)


@pytest.mark.parametrize("n,batch", [(2, 1), (16, 3), (16, 401), (1024, 32),
                                     (1024, 401), (4096, 3), (4096, 401),
                                     (16384, 2)])
@pytest.mark.parametrize("q_bits", [30, 61])
def test_ntt_kernels_match_plain(cuda, one_cta, n, batch, q_bits):
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
def test_split_kernels_match_plain(cuda, one_cta, n, batch, q_bits):
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
    # The RNS product of two distinct primes: three stacked transforms of
    # two passes each and one K4.rows for the basis; each local pass in the
    # cluster form's rule's kernel.
    one, stacked = _routed(cuda, n, 1, 2), _routed(cuda, n, 2, 2, True)
    assert dict(_build.launches) == _launches(
        (one, 5), (stacked, 3), ({"K7": 2, "K4": 1, "K4.rows": 1}, 1))


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


@pytest.fixture
def fresh_graphs(cuda):
    """The key switch's graph cache and its counters emptied before and
    after the test."""
    def empty():
        torch.cuda.synchronize()
        ks_mod.graphs.clear()
        ks_mod.graph_stats.clear()

    empty()
    yield
    empty()


def _calls():
    """The graph cache's call counters (`graph_stats` also holds
    `capture_s` and `pool_bytes`)."""
    return {k: ks_mod.graph_stats[k] for k in ("eager", "captures",
                                               "replays")}


def _ks_shape(rng, n, moduli, kc, dev):
    """A key switch over `moduli` (decomposition primes, then the key
    prime) with one set of keys: make() gives the arguments of a call on
    fresh result and target."""
    ds = len(moduli) - 1

    def rows(count):
        return torch.stack([_rand(rng, (n,), q, dev) for q in moduli[:count]])

    keys = torch.stack([torch.stack([rows(ds + 1) for _ in range(kc)])
                        for _ in range(ds)])
    msf = [nt.inverse_mod(moduli[-1] % q, q) for q in moduli[:ds]]

    def make():
        result = torch.stack([rows(ds) for _ in range(kc)])
        return (result, rows(ds), n, ds, ds + 1, ds + 1, kc, moduli, keys,
                msf)
    return make


def _ks_moduli(n, bits, repeat=False):
    """Distinct primes of the bit sizes, the last the key prime; with
    `repeat` the second decomposition prime equal to the first (the
    unstacked branch)."""
    moduli = list(nt.generate_primes(len(bits), bits[0], True, ntt_size=n))
    if repeat:
        moduli[1] = moduli[0]
    return moduli


def test_key_switch_graph_calls_match_plain(cuda, fresh_graphs):
    """A key's first call runs eagerly, its second captures, the rest
    replay: each equal word for word to the plain pipeline, and each
    counting the same launches."""
    n = 1 << 15
    make = _ks_shape(np.random.default_rng(21), n, _ks_moduli(n, (49,) * 4),
                     2, cuda)
    counts = []
    for _ in range(5):
        args = make()
        before = args[0].clone()
        _build.reset_launches()
        got = key_switch(*args)
        counts.append(dict(_build.launches))
        torch.cuda.synchronize()
        assert torch.equal(got, ks_mod.key_switch_plain(*args))
        assert torch.equal(args[0], before)
    assert _calls() == {"eager": 1, "captures": 1, "replays": 3}
    assert all(c == counts[0] for c in counts)
    assert counts[0]["K10"] == 1 and counts[0]["K11"] == 2


def test_key_switch_graph_outputs_are_not_shared(cuda, fresh_graphs):
    """Eight calls in flight on one graph: each output its own tensor,
    all still right after the eighth call."""
    n = 1 << 15
    make = _ks_shape(np.random.default_rng(22), n, _ks_moduli(n, (49,) * 4),
                     2, cuda)
    calls = [make() for _ in range(8)]
    outs = [key_switch(*args) for args in calls]
    torch.cuda.synchronize()
    assert len({o.data_ptr() for o in outs}) == 8
    for args, got in zip(calls, outs):
        assert torch.equal(got, ks_mod.key_switch_plain(*args))
    assert ks_mod.graph_stats["replays"] == 6


def test_key_switch_graphs_of_interleaved_shapes(cuda, fresh_graphs):
    """ds 2 and ds 3 at 2^15 (stacked) and a repeated decomposition prime
    (the unstacked branch), called in turn: a graph each."""
    n = 1 << 15
    rng = np.random.default_rng(23)
    shapes = [_ks_shape(rng, n, _ks_moduli(n, bits, repeat), 2, cuda)
              for bits, repeat in (((49,) * 3, False), ((49,) * 4, False),
                                   ((49,) * 3, True))]
    for _ in range(3):
        for make in shapes:
            args = make()
            got = key_switch(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, ks_mod.key_switch_plain(*args))
    assert _calls() == {"eager": 3, "captures": 3, "replays": 3}
    assert sum(v is not None for v in ks_mod.graphs.values()) == 3


def test_key_switch_graph_after_clear_plan_cache(cuda, fresh_graphs):
    """clear_plan_cache drops the graphs (they hold the plans' addresses):
    the next call of the key runs eagerly on the new plans."""
    from hexl_tpu_torch.ntt import clear_plan_cache

    n = 1 << 15
    make = _ks_shape(np.random.default_rng(24), n, _ks_moduli(n, (49,) * 4),
                     2, cuda)
    for turn in range(2):
        for _ in range(3):
            args = make()
            got = key_switch(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, ks_mod.key_switch_plain(*args))
        if turn == 0:
            clear_plan_cache()
            assert not ks_mod.graphs
    assert _calls() == {"eager": 2, "captures": 2, "replays": 2}


def test_key_switch_graphs_of_one_key_at_every_level(cuda, fresh_graphs,
                                                     monkeypatch):
    """One relinearisation key over {60, 40 x 4, 60} at 2^15 used at ds 5 ..
    1 of kms 6 (keys[:ds], as a CKKS chain uses it below the top level): a
    graph a level, each call equal to the plain pipeline word for word;
    each capture adds to `capture_s` and its pool to `pool_bytes`, and
    evicted levels take theirs off again."""
    n = 1 << 15
    moduli = (nt.generate_primes(1, 59, False, ntt_size=n)
              + nt.generate_primes(4, 39, False, ntt_size=n)
              + nt.generate_primes(2, 59, False, ntt_size=n)[1:])
    kms, kc = len(moduli), 2
    rng = np.random.default_rng(26)

    def rows(count):
        return torch.stack([_rand(rng, (n,), q, cuda)
                            for q in moduli[:count]])

    keys = torch.stack([torch.stack([rows(kms) for _ in range(kc)])
                        for _ in range(kms - 1)])
    msf = [nt.inverse_mod(moduli[-1] % q, q) for q in moduli[:kms - 1]]
    for _ in range(3):
        for ds in range(kms - 1, 0, -1):
            args = (torch.stack([rows(ds) for _ in range(kc)]), rows(ds), n,
                    ds, kms, ds + 1, kc, moduli, keys[:ds], msf[:ds])
            got = key_switch(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, ks_mod.key_switch_plain(*args))
    assert _calls() == {"eager": 5, "captures": 5, "replays": 5}
    pools = [e.pool_bytes for e in ks_mod.graphs.values()]
    assert len(pools) == 5 and all(p > 0 for p in pools)
    assert ks_mod.graph_stats["pool_bytes"] == sum(pools)
    assert ks_mod.graph_stats["capture_s"] > 0
    monkeypatch.setattr(ks_mod, "GRAPH_CACHE", 4)
    args = (torch.stack([rows(1) for _ in range(kc)]), rows(1), n, 1, kms,
            2, kc, moduli, keys[:1].clone(), msf[:1])
    key_switch(*args)                  # a new key: evicts ds 5 and 4
    assert ks_mod.graph_stats["pool_bytes"] == sum(pools[2:])


def test_mac_flush_at_ds_20_with_worst_case_operands(cuda):
    """K10 at ds 20 with 60-bit rows, t = 4q - 1 and keys q - 1: 2^126.3
    before the flush, within a factor of 3.2 of the 128-bit wrap; equal to
    the exact sum and to the plain version, above and below the top
    level."""
    ds, n = 20, 4096 + 2
    for kms in (21, 22):
        moduli = tuple(nt.generate_primes(kms, 59, False, ntt_size=1))
        t, keys, want, _ = ks_cases.worst_case_mac(moduli, ds, kms, n, cuda)
        c = ks_mod.constants(moduli, tuple(pow(moduli[-1], -1, q)
                                           for q in moduli[:ds]), ds, cuda)
        for approx in (False, True):
            got = ks_mod.mac_flush(t, keys, c, ds, 2, kms, approx)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert torch.equal(got, ks_mod.mac_flush_plain(
                t, keys, c.mac, ds, 2, kms, approx))


def test_ckks_chain_every_level_matches_the_reference(cuda, fresh_graphs):
    """The benchmark's `ckks-n32768-mult-levels` multiply (`dyadic_multiply`
    then `key_switch`) at each of its 19 levels, in the timed shapes and
    on its graphs, word for word against the plain reference
    (`hebench/levels.py`)."""
    from hebench import levels, registry

    reg = registry.Registry(registry.load_benchmark())
    op, st = levels.setup(reg, "ckks-n32768-mult-levels", 2**31 + 22, cuda)
    assert _calls() == {"eager": 19, "captures": 19, "replays": 0}
    assert levels.mismatches(op, st) == {d: [0, 0] for d in st.levels}
    assert _calls()["replays"] == 19


def test_key_switch_inside_an_outer_capture(cuda, fresh_graphs):
    """Under an outer capture the chain runs eagerly, so the outer graph
    records its kernels; replayed on new operands it gives their switch."""
    n = 1 << 15
    make = _ks_shape(np.random.default_rng(25), n, _ks_moduli(n, (49,) * 4),
                     2, cuda)
    for _ in range(3):
        key_switch(*make())
    torch.cuda.synchronize()
    args = make()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer, capture_error_mode="relaxed"):
        got = key_switch(*args)
    assert ks_mod.graph_stats["eager"] == 2
    fresh = make()
    args[0].copy_(fresh[0])
    args[1].copy_(fresh[1])
    outer.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, ks_mod.key_switch_plain(*fresh))


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
    # ds = 2 at 2^15, distinct primes: three stacked transforms over the
    # decomposition primes (the target's inverses, the converted block,
    # the mod-down's forwards) and the key prime's forward and inverse, of
    # two passes each; the rows' and the key prime's base conversion; K10,
    # K11 twice.
    assert dict(_build.launches) == _launches(
        (_routed(cuda, n, 2, 1, True), 2), (_routed(cuda, n, 2, 2, True), 1),
        (_routed(cuda, n, 1, 2), 2),
        ({"K9": 2, "K8.reduce.rows": 1, "K8.reduce": 1, "K10": 1, "K11": 2},
         1))


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
               ("K4", "K5", "K6", "K6.shard.cl", "K8.reduce", "K9", "K10",
                "K11", "K16")), launched


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
def test_radix_walk_at_every_degree(cuda, one_cta, log_n):
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
def test_radix_local_pass_at_every_shard_count(cuda, one_cta, log_d):
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
    """The approximate instantiations of K5 (lean16, lean8, approx), the
    chain kernels, every radix walk of K1/K6/K7 (four u64 schemes), K2's
    packed walk, K3's kernels (exact, lean16, lean8 and approx), K12's
    radix walk, K16, every eltwise body (the streaming template: 17 exact
    and 6 approximate instantiations), K10 at every kc it is built for
    (exact and approximate) and the approximate instantiations of K9 and
    K11, from the -Xptxas -v report of the build."""
    import re
    res = _build.kernel_resources(_build.build_all()["log"])
    new = {k: v for k, v in res.items()
           if "chain_kernel" in k or re.search(r"kernelIyLi[123]E", k)
           or re.search(r"radix_(packed_)?(fwd|inv)_kernel", k)
           or re.search(r"poly_\w+_kernel", k) or "stage_kernel" in k
           or re.search(r"eltwise_kernel|mac_flush_kernel", k)
           or re.search(r"(dyadic|spread|fold)_kernelILb1E", k)}
    radix = [k for k in new if "radix_" in k]
    assert len(radix) == ((4 + 8) * 7 + (1 + 2) * 10 + 2 * 4 * 2
                          + 2 * (6 + 6 + 3)), radix
    k3 = [k for k in new if "poly_" in k]
    assert len(k3) == 4 * (3 + 6), k3
    assert len([k for k in new if "stage_kernel" in k]) == 2
    eltwise = [k for k in new if "eltwise_kernel" in k]
    assert len(eltwise) == 17 + 6, eltwise
    mac = [k for k in new if "mac_flush_kernel" in k]
    assert len(mac) == 2 * ks_mod.MAC_GROUP, mac
    composites = [k for k in new
                  if re.search(r"(dyadic|spread|fold)_kernel", k)]
    assert len(composites) == 3, composites
    assert len(new) >= (3 * 6 * 3 + 2 + 3 + len(radix) + len(k3) + 2
                        + len(eltwise) + len(mac) + len(composites))
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


def test_prewarmed_pair_builds_and_looks_up_nothing_new(cuda, monkeypatch):
    """After prewarm, the first public pair of that shape compiles,
    loads and binds nothing: every C entry it calls is already bound."""
    from hexl_tpu_torch import prewarm
    n, batch = 1 << 14, 4
    (record,) = prewarm([(n, 60)], batch=batch, verbose=False, device=cuda)
    q = record[1]
    bound = dict(_build._funcs)

    def refuse():
        raise AssertionError("build_all after prewarm")

    monkeypatch.setattr(_build, "build_all", refuse)
    x = _rand(np.random.default_rng(3), (batch, n), q, cuda)
    e = NTT(n, q, device=cuda)
    back = e.inverse(e.forward(x))
    torch.cuda.synchronize()
    assert torch.equal(back, x)
    assert dict(_build._funcs) == bound


@pytest.mark.parametrize("n,q_bits", [(1 << 12, 50), (1 << 16, 60)])
def test_plan_file_drives_the_kernels(cuda, tmp_path, monkeypatch, n,
                                      q_bits):
    from hexl_tpu_torch.ntt import plan as plan_mod
    monkeypatch.setattr(plan_mod, "_PLAN_CACHE", {})
    q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    plan_mod.get_plan(n, q)
    path = str(tmp_path / "plans.npz")
    assert plan_mod.save_plan_cache(path) == 1
    plan_mod.clear_plan_cache()
    assert plan_mod.load_plan_cache(path) == 1
    loaded, fresh = plan_mod.get_plan(n, q), plan_mod.NttPlan.build(n, q)
    x = _rand(np.random.default_rng(n), (3, n), q, cuda)
    kernels = _routed(cuda, n, 1, 3)
    before = dict(_build.launches)
    y = cuda_ntt.fwd_ntt(x, loaded)
    back = cuda_ntt.inv_ntt(y, loaded)
    torch.cuda.synchronize()
    assert all(_build.launches[k] > before.get(k, 0) for k in kernels)
    assert torch.equal(y, torch_ntt.fwd_ntt(x, fresh))
    assert torch.equal(back, x)


def test_trace_on_the_card_holds_kernel_events(cuda, tmp_path):
    import json
    from hexl_tpu_torch.utils.profiling import trace
    n = 1 << 12
    q = nt.generate_primes(1, 50, True, ntt_size=n)[0]
    e = NTT(n, q, device=cuda)
    x = _rand(np.random.default_rng(5), (2, n), q, cuda)
    e.forward(x)
    torch.cuda.synchronize()
    with trace(str(tmp_path)) as path:
        with torch.profiler.record_function("pair"):
            e.inverse(e.forward(x))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [ev["name"] for ev in events if ev.get("cat") == "kernel"]
    # The pair's kernels: K1's, or the cluster form's where the rule routes
    # a grid of two transforms there.
    walk = ("rns_cluster" if "K1.rns.cl" in _routed(cuda, n, 1, 2)
            else "radix")
    assert any(f"{walk}_fwd_kernel" in k for k in names)
    assert any(f"{walk}_inv_kernel" in k for k in names)
    assert any(ev.get("name") == "pair" for ev in events)


TILE_ARITH = [(60, 64, "exact"), (62, 64, "exact"), (29, 32, "exact"),
              (59, 64, "lean16"), (60, 64, "lean8"), (60, 64, "approx")]


@pytest.mark.parametrize("q_bits,word,scheme", TILE_ARITH)
@pytest.mark.parametrize("log_d", range(1, 7))
def test_cross_tile_form_matches_plain(cuda, monkeypatch, log_d, q_bits,
                                       word, scheme):
    """K5's tiled form (forced in place of the rule's pick) at every D of
    the split, batches 1 and 3, forward and inverse at OMF 1 and 2,
    against the plain versions; each call launches the tiled form once."""
    n = hier.LOCAL_N << log_d
    q = (nt.generate_primes(1, 61, False, ntt_size=n)[0] if q_bits == 62
         else nt.generate_primes(1, q_bits, True, ntt_size=n)[0])
    plan = get_plan(n, q)
    rng = np.random.default_rng(400 + log_d + q_bits)
    monkeypatch.setattr(hier, "cross_form", lambda *args: "tile")
    f_wide, i_wide = {"exact": (4, 2), "lean16": (16, 8),
                      "lean8": (8, 4), "approx": (4, 2)}[scheme]
    name = hier.kernel_name("K5.tile", word, scheme)
    for batch in (1, 3):
        blocks = (batch, 1 << log_d, hier.LOCAL_N)
        x = _rand(rng, blocks, f_wide * q, cuda)
        _build.reset_launches()
        got = hier.cross(x, plan, True, 1, word, scheme)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {name: 1}
        assert torch.equal(got, hier.cross_fwd_plain(x, plan, word, scheme))
        x = _rand(rng, blocks, i_wide * q, cuda)
        for omf in (1, 2):
            got = hier.cross(x, plan, False, omf, word, scheme)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.cross_inv_plain(x, plan, omf, word,
                                                         scheme))


def test_public_ntt_at_2_20_takes_the_tiled_form(cuda):
    """The rule's pick: NTT(2^20, 60-bit) runs K5 in its tiled form, the
    round trip exact; NTT(2^19) keeps the column form."""
    for n, k5 in ((1 << 20, "K5.tile"), (1 << 19, "K5")):
        q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
        engine = NTT(n, q, device=cuda)
        x = _rand(np.random.default_rng(7), (2, n), q, cuda)
        _build.reset_launches()
        back = engine.inverse(engine.forward(x))
        torch.cuda.synchronize()
        local = {k: v for k, v in _routed(cuda, n, 1, 2).items() if k != "K5"}
        assert dict(_build.launches) == _launches(({k5: 1}, 2), (local, 2))
        assert torch.equal(back, x)


def test_cross_tile_instantiations_do_not_spill(cuda):
    """K5's tiled form: the forward and both inverses at every D, in the
    four u64 schemes and u32, from the -Xptxas -v report."""
    import re
    res = _build.kernel_resources(_build.build_all()["log"])
    tile = {k: v for k, v in res.items()
            if re.search(r"cross_tile_(fwd|inv)_kernel", k)}
    assert len(tile) == 3 * 6 * 5, sorted(tile)
    assert not {k: v for k, v in tile.items() if v[2] or v[3]}


# -- the stacked transform (K1.rns, K2.rns, K5.rns, K6.rns) and the row ops --

def _stacked_basis(n, k, lean=False):
    """k distinct primes = 1 mod 2n of mixed bit lengths (up to the largest
    below 2^62, or below 2^60 for the lean schemes)."""
    bits = (59, 29, 50, 45) if lean else (29, 62, 50, 60)
    out = []
    for i in range(k):
        b = bits[i % len(bits)]
        ps = (nt.generate_primes(4, 61, False, ntt_size=n) if b == 62
              else nt.generate_primes(4, b, True, ntt_size=n))
        out.append(next(q for q in ps if q not in out))
    return out


def _stacked_rows(rng, moduli, shape, factor, dev):
    return torch.stack([_rand(rng, shape, factor * q, dev) for q in moduli])


@pytest.mark.parametrize("n,k,batch", [(64, 3, 5), (64, 1, 2), (1024, 3, 2),
                                       (1 << 14, 16, 1), (1 << 15, 3, 3),
                                       (1 << 17, 16, 1), (1 << 20, 3, 1)])
@pytest.mark.parametrize("scheme", ["exact", "lean16", "lean8"])
def test_stacked_kernels_match_plain(cuda, one_cta, n, k, batch, scheme):
    """fwd_ntt_rns/inv_ntt_rns over the whole basis, every IMF/OMF pair,
    against the plain stacked walk; one launch a direction up to 2^14, two
    above, under the stacked names."""
    moduli = _stacked_basis(n, k, scheme != "exact")
    rplan = rns.get_rns_plan(n, moduli)
    rng = np.random.default_rng(n + k + batch)
    for forward, pairs in ((True, [(i, o) for i in (1, 2, 4) for o in (1, 4)]),
                           (False, [(i, o) for i in (1, 2) for o in (1, 2)])):
        fn = rns.fwd_ntt_rns if forward else rns.inv_ntt_rns
        plain = rns.fwd_ntt_rns_plain if forward else rns.inv_ntt_rns_plain
        for imf, omf in pairs:
            x = _stacked_rows(rng, moduli, (batch, n), imf, cuda)
            _build.reset_launches()
            got = fn(x, rplan, imf, omf, scheme)
            torch.cuda.synchronize()
            assert sum(_build.launches.values()) == (1 if n <= 1 << 14
                                                     else 2)
            assert all(".rns" in name for name in _build.launches)
            assert torch.equal(got, plain(x, rplan, imf, omf, scheme))


@pytest.mark.parametrize("log_d", range(1, 7))
@pytest.mark.parametrize("form", ["column", "tile"])
def test_stacked_cross_forms_match_plain(cuda, monkeypatch, log_d, form):
    """K5.rns in each form (the rule's pick forced) and K6.rns pass by pass
    against each row's plain pass, batches 1 and 3."""
    n = 1 << (14 + log_d)
    moduli = _stacked_basis(n, 3)
    rplan = rns.get_rns_plan(n, moduli)
    rows = rplan.descriptors(cuda)
    monkeypatch.setattr(hier, "cross_form", lambda *args: form)
    rng = np.random.default_rng(log_d)
    for batch in (1, 3):
        blocks = (batch, 1 << log_d, hier.LOCAL_N)
        xf = _stacked_rows(rng, moduli, (batch, n), 4, cuda)
        xi = _stacked_rows(rng, moduli, (batch, n), 2, cuda)
        got = rns._cross(xf, rows, rplan, batch, True, 1, "exact")
        want = torch.stack([hier.cross_fwd_plain(xf[i].view(blocks), p)
                            for i, p in enumerate(rplan.plans)])
        torch.cuda.synchronize()
        assert torch.equal(got, want.view(got.shape))
        for omf in (1, 2):
            got = rns._cross(xi, rows, rplan, batch, False, omf, "exact")
            want = torch.stack([hier.cross_inv_plain(xi[i].view(blocks), p,
                                                     omf)
                                for i, p in enumerate(rplan.plans)])
            torch.cuda.synchronize()
            assert torch.equal(got, want.view(got.shape))
        got = rns._local(xf, rows, rplan, batch, True, 4, "exact")
        want = torch.stack([hier.local_fwd_plain(xf[i], p, 4)
                            for i, p in enumerate(rplan.plans)])
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 3, 16])
def test_row_ops_match_plain(cuda, k):
    moduli = _stacked_basis(4096, k)
    consts = ops.row_constants(tuple(moduli), cuda)
    rng = np.random.default_rng(k)
    for imf in (1, 2, 4):
        a, b = (_stacked_rows(rng, moduli, (3, 4097), imf, cuda)
                for _ in range(2))
        got = ops.mult_mod_rows(a, b, moduli, imf)
        torch.cuda.synchronize()
        assert torch.equal(got, torch_kernels.mult_mod_rows(a, b, consts,
                                                            imf))
    x = _rand(rng, (k, 3, 4097), 1 << 64, cuda)
    for omf in (1, 2):
        got = ops.reduce_mod_rows(x, moduli, omf)
        torch.cuda.synchronize()
        assert torch.equal(got, torch_kernels.reduce_mod_rows(x, consts,
                                                              omf))


def test_stacked_instantiations_do_not_spill(cuda):
    """Every stacked instantiation (K1.rns, K2.rns, K5.rns in both forms,
    K6.rns and the row ops, exact and approximate), from the -Xptxas -v
    report of the build."""
    import re
    res = _build.kernel_resources(_build.build_all()["log"])
    stacked = {k: v for k, v in res.items()
               if re.search(r"_rns_kernel|eltwise_rows_kernel", k)}
    assert len(stacked) == (2 * 3 * 7 + 3 + 2 * 3 * 2 + 2 * 2 * 3 * 6
                            + 2 * 2)
    spills = {k: v for k, v in stacked.items() if v[2] or v[3]}
    assert not spills, spills


def test_stacked_entry_points_never_take_the_plain_path(cuda, monkeypatch):
    """RnsNTT and rns_poly_mult_mod on the card: one launch a direction (two
    above 2^14) for the basis, never a plain version or a loop a prime."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("fwd_stages", "inv_stages", "inv_final"):
        monkeypatch.setattr(torch_ntt, name, refuse)
    for name in ("mult_mod", "mult_mod_rows"):
        monkeypatch.setattr(torch_kernels, name, refuse)
    monkeypatch.setattr(cuda_ntt, "fwd_ntt", refuse)
    monkeypatch.setattr(cuda_ntt, "inv_ntt", refuse)
    monkeypatch.setattr(poly, "poly_mult", refuse)
    rng = np.random.default_rng(3)
    for n in (1 << 12, 1 << 17):
        kernels = _launches((_routed(cuda, n, 4, 2, True), 2))
        moduli = _stacked_basis(n, 4)
        engine = RnsNTT(n, moduli)
        x = _stacked_rows(rng, moduli, (2, n), 1, cuda)
        _build.reset_launches()
        back = engine.inverse(engine.forward(x))
        torch.cuda.synchronize()
        assert dict(_build.launches) == kernels
        assert torch.equal(back, x)
        _build.reset_launches()
        rns_poly_mult_mod(x, x, n, moduli)
        torch.cuda.synchronize()
        assert sum(_build.launches.values()) == (4 if n <= 1 << 14 else 7)


# -- the cluster form (K1.rns.cl, K6.rns.cl, K6.shard.cl) --------------------

@pytest.mark.parametrize("clusters", rns.CLUSTER_SIZES)
@pytest.mark.parametrize("log_n", range(12, 21))
def test_cluster_kernels_match_plain(cuda, monkeypatch, clusters, log_n):
    """K1.rns.cl (N <= 2^14) and K6.rns.cl (the shards above) with the
    rule's C forced, k = 1 and 3 primes (batch 3; 1 and 2 primes at batch
    1 above 2^14), every IMF/OMF pair, against the plain cluster walk, one
    launch of the cluster kernel a call; and the routed one-prime calls
    (batches 1 and 3, to 2^16) against the flat walk."""
    monkeypatch.setattr(rns, "cluster_for", lambda *args: clusters)
    n = 1 << log_n
    kernel = "K1.rns.cl" if log_n <= 14 else "K6.rns.cl"
    rng = np.random.default_rng(log_n + clusters)
    pairs = ([(True, i, o) for i in (1, 2, 4) for o in (1, 4)]
             + [(False, i, o) for i in (1, 2) for o in (1, 2)])
    for k, batch in ((1, 3), (3, 3)) if log_n <= 14 else ((1, 1), (2, 1)):
        moduli = _stacked_basis(n, k)
        rplan = rns.get_rns_plan(n, moduli)
        for forward, imf, omf in pairs:
            x = _stacked_rows(rng, moduli, (batch, n), imf, cuda)
            _build.reset_launches()
            got = (rns.fwd_ntt_rns if forward else rns.inv_ntt_rns)(
                x, rplan, imf, omf)
            torch.cuda.synchronize()
            assert _build.launches[kernel] == 1
            plain = (rns.fwd_ntt_rns_cluster_plain if forward
                     else rns.inv_ntt_rns_cluster_plain)
            assert torch.equal(got, plain(x, rplan, clusters, imf, omf))
    if log_n > 16:
        return
    plan = get_plan(n, _modulus(61, n))
    for batch in (1, 3):
        for forward, imf, omf in pairs:
            x = _rand(rng, (batch, n), imf * plan.q, cuda)
            _build.reset_launches()
            got = (cuda_ntt.fwd_ntt if forward else cuda_ntt.inv_ntt)(
                x, plan, imf, omf)
            torch.cuda.synchronize()
            assert _build.launches[kernel] == 1
            plain = torch_ntt.fwd_ntt if forward else torch_ntt.inv_ntt
            assert torch.equal(got, plain(x, plan, imf, omf))


@pytest.mark.parametrize("clusters", rns.CLUSTER_SIZES)
@pytest.mark.parametrize("log_l", range(12, 17))
def test_shard_cluster_kernel_matches_plain(cuda, monkeypatch, clusters,
                                            log_l):
    """K6.shard.cl (a DistNTT position's local pass on a cluster of C
    CTAs a shard, or above 2^14 a 2^14 sub-shard after K5) with the rule's
    C forced, at every position of D = 2 and 4, the forward at OMF 1 and
    4 and the inverse, batches 1 and 3, against its plain version; one
    launch of the cluster kernel a call."""
    from hexl_tpu_torch.ntt import shard
    monkeypatch.setattr(rns, "cluster_for", lambda *args: clusters)
    rng = np.random.default_rng(log_l + clusters)
    want = {shard.CLUSTER_NAME: 1, **({"K5": 1} if log_l > 14 else {})}
    for d in (2, 4):
        plan = get_plan(d << log_l, _modulus(61, d << log_l))
        for r in range(d):
            for batch in (1, 3):
                for forward, omf in ((True, 1), (True, 4), (False, 1)):
                    x = _rand(rng, (batch, 1 << log_l),
                              (4 if forward else 2) * plan.q, cuda)
                    _build.reset_launches()
                    got = shard.local(x, plan, r, d, forward, omf)
                    torch.cuda.synchronize()
                    assert dict(_build.launches) == want
                    assert torch.equal(got, shard.local_cluster_plain(
                        x, plan, r, d, forward, omf, clusters))


def test_cluster_instantiations_do_not_spill(cuda):
    """Every instantiation of the cluster form, from the -Xptxas -v report
    of the build: the forward, the whole inverse and the shard's inverse
    at 11 (C, chunk) shapes each."""
    import re
    res = _build.kernel_resources(_build.build_all()["log"])
    clustered = {k: v for k, v in res.items()
                 if re.search(r"rns_cluster_(fwd|inv)_kernel", k)}
    assert len(clustered) == 11 + 11 + 11
    spills = {k: v for k, v in clustered.items() if v[2] or v[3]}
    assert not spills, spills


def test_cluster_rule_on_the_card(cuda):
    """`cluster_for` on this card: C = 1 from a wave on; below it, a C
    whose clusters the card holds all at once."""
    sms = cuda_ntt.sm_count(cuda)
    for log_n in (12, 13, 14):
        for ctas in range(1, sms + 8):
            c = rns.cluster_for(log_n, ctas, sms, cuda)
            if ctas >= sms:
                assert c == 1
            elif c > 1:
                assert ctas <= rns.max_active_clusters(log_n, c, cuda)


# -- the approx scheme (the Pallas kernels' butterflies) and the eltwise
# family's approximate quotients --

@pytest.mark.parametrize("n,batch", [(2, 1), (16, 401), (64, 8192),
                                     (1024, 401), (4096, 3), (8192, 2),
                                     (16384, 2), (1 << 15, 3), (1 << 20, 1)])
@pytest.mark.parametrize("q_bits", [29, 50, 60, 61])
def test_approx_ntt_kernels_match_plain(cuda, n, batch, q_bits):
    """K1/K2 (N <= 2^14) and K5/K6 (above) in "approx" against the plain
    approx walk at every IMF/OMF, and at OMF 1 against the exact kernels;
    "61" is the largest prime below 2^61."""
    q = (nt.generate_primes(1, 60, False, ntt_size=n)[0] if q_bits == 61
         else nt.generate_primes(1, q_bits, True, ntt_size=n)[0])
    plan = get_plan(n, q)
    rng = np.random.default_rng(n + q_bits)
    for imf in (1, 2, 4):
        x = _rand(rng, (batch, n), imf * q, cuda)
        for omf in (1, 4):
            got = cuda_ntt.fwd_ntt(x, plan, imf, omf, 64, "approx")
            torch.cuda.synchronize()
            assert torch.equal(got, torch_ntt.fwd_ntt(x, plan, imf, omf, 64,
                                                      "approx"))
            if omf == 1:
                assert torch.equal(got, cuda_ntt.fwd_ntt(x, plan, imf, 1))
    for imf in (1, 2):
        x = _rand(rng, (batch, n), imf * q, cuda)
        for omf in (1, 2):
            got = cuda_ntt.inv_ntt(x, plan, imf, omf, 64, "approx")
            torch.cuda.synchronize()
            assert torch.equal(got, torch_ntt.inv_ntt(x, plan, imf, omf, 64,
                                                      "approx"))


@pytest.mark.parametrize("log_n", range(1, 15))
def test_approx_poly_kernel_every_form(cuda, log_n, monkeypatch):
    """K3 in "approx" in every form it takes, against the plain approx
    chain and the exact K3."""
    n = 1 << log_n
    q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(log_n)
    a, b = (_rand(rng, (3, n), q, cuda) for _ in range(2))
    want = poly.poly_mult_plain(a, b, plan, "approx")
    for form in poly.forms_of(n):
        monkeypatch.setattr(poly, "form_for", lambda *args, f=form: f)
        _build.reset_launches()
        got = poly.poly_mult(a, b, plan, "approx")
        torch.cuda.synchronize()
        assert dict(_build.launches) == {poly.FORMS[form] + ".approx": 1}
        assert torch.equal(got, want)
        assert torch.equal(got, poly.poly_mult(a, b, plan))


@pytest.mark.parametrize("log_n,q_bits", [(10, 29), (14, 61), (17, 50)])
def test_approx_stage_kernel_matches_plain(cuda, log_n, q_bits):
    """K16 in "approx" at every stage, the fused final stage at every
    OMF."""
    from hexl_tpu_torch.parallel import pipeline
    n = 1 << log_n
    q = (nt.generate_primes(1, 60, False, ntt_size=n)[0] if q_bits == 61
         else nt.generate_primes(1, q_bits, True, ntt_size=n)[0])
    plan = get_plan(n, q)
    rng = np.random.default_rng(log_n)
    for k in range(log_n):
        last = k == log_n - 1
        for forward, bound, omfs in ((True, 4 * q, (1, 4) if last else (4,)),
                                     (False, 2 * q,
                                      (1, 2) if last else (2,))):
            x = _rand(rng, (2, n), bound, cuda)
            for omf in omfs:
                got = pipeline.stages(x, plan, forward, k, k + 1, omf,
                                      "approx")
                torch.cuda.synchronize()
                assert torch.equal(got, pipeline.stages_plain(
                    x, plan, forward, k, k + 1, omf, "approx"))


@pytest.mark.parametrize("d,log_l", [(2, 12), (8, 14), (4, 15)])
def test_approx_shard_local_matches_plain(cuda, d, log_l):
    """A DistNTT position's local pass in "approx" (K6 with a shard base,
    K5 on a shard's stages above 2^14), one CTA a chunk under a wave."""
    from hexl_tpu_torch.ntt import shard
    n = d << log_l
    q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(n)
    for r in (0, d - 1):
        x = _rand(rng, (3, n // d), 4 * q, cuda)
        for omf in (1, 4):
            _build.reset_launches()
            got = shard.local(x, plan, r, d, True, omf, "approx")
            torch.cuda.synchronize()
            assert "K6.approx" in _build.launches
            assert torch.equal(got, shard.local_fwd_plain(x, plan, r, d,
                                                          omf, "approx"))
        x = _rand(rng, (3, n // d), 2 * q, cuda)
        got = shard.local(x, plan, r, d, False, 1, "approx")
        torch.cuda.synchronize()
        assert torch.equal(got, shard.local_inv_plain(x, plan, r, d,
                                                      "approx"))


@pytest.mark.parametrize("q_bits", [20, 29, 49, 60, 61, 62])
def test_approx_eltwise_kernels_match_plain(cuda, q_bits, monkeypatch):
    """K4/K8's approximate instantiations (the switch forced on) against
    the plain bodies with approx=True, at every IMF/OMF, and the row ops."""
    from hexl_tpu_torch import config
    monkeypatch.setattr(config, "approx_butterflies", lambda device: True)
    if q_bits == 62:
        q = nt.generate_primes(1, 61, False)[0]
    else:
        q = nt.generate_primes(1, q_bits, True)[0]
    rng = np.random.default_rng(q_bits)
    size = 65537
    for imf in (1, 2, 4):
        a, b = (_rand(rng, (size,), imf * q, cuda) for _ in range(2))
        _build.reset_launches()
        got = ops.mult_mod(a, b, q, imf)
        assert dict(_build.launches) == {"K4.approx": 1}
        assert torch.equal(got, torch_kernels.mult_mod(a, b, q, imf, True))
    if q < 1 << 61:
        for imf in (1, 2, 4, 8):
            a, c = (_rand(rng, (size,), imf * q, cuda) for _ in range(2))
            w = nt.reduce_mod(123456789 % (imf * q), q, imf)
            wp = nt.barrett_factor(w, 64, q)
            assert torch.equal(ops.fma_mod(a, w, wp, c, q, imf),
                               torch_kernels.fma_mod_preconned(
                                   a, w, wp, c, q, imf, True))
    wide = _rand(rng, (size,), 1 << 64, cuda)
    for omf in (1, 2):
        assert torch.equal(ops.reduce_mod(wide, q, q, omf),
                           torch_kernels.reduce_mod(wide, q, q, omf, True))
    for cmp in torch_kernels.CMP_NAMES:
        assert torch.equal(ops.cmp_sub_mod(wide, q, cmp, 1 << 63, 5),
                           torch_kernels.cmp_sub_mod(wide, q, cmp, 1 << 63,
                                                     5, True))
    if q % 2:
        a = _rand(rng, (size,), q, cuda)
        assert torch.equal(ops.montgomery_form_in(a, q),
                           torch_kernels.montgomery_form_in(a, q, True))
    moduli = (q, nt.generate_primes(1, 40, True)[0])
    consts = ops.row_constants(moduli, cuda)
    x = torch.stack([_rand(rng, (4097,), 4 * m, cuda) for m in moduli])
    y = torch.stack([_rand(rng, (4097,), 4 * m, cuda) for m in moduli])
    assert torch.equal(ops.mult_mod_rows(x, y, moduli, 4),
                       torch_kernels.mult_mod_rows(x, y, consts, 4, True))
    x = torch.stack([_rand(rng, (4097,), 1 << 64, cuda) for _ in moduli])
    for omf in (1, 2):
        assert torch.equal(ops.reduce_mod_rows(x, moduli, omf),
                           torch_kernels.reduce_mod_rows(x, consts, omf,
                                                         True))


# -- the composites' approximate quotients and K3 in the lean schemes ---------

@pytest.fixture
def approx_switch(monkeypatch):
    """The approximation switch forced on (`config.approx_butterflies`)."""
    from hexl_tpu_torch import config
    monkeypatch.setattr(config, "approx_butterflies", lambda device: True)


def _approx_modulus(q_bits, n=1024):
    """q just above 2^q_bits, or, for 61, the largest prime below 2^61."""
    if q_bits == 61:
        return nt.generate_primes(1, 60, False, ntt_size=n)[0]
    return nt.generate_primes(1, q_bits, True, ntt_size=n)[0]


@pytest.mark.parametrize("weights", [1, 3])
def test_approx_dyadic_kernel_matches_plain(cuda, weights, approx_switch):
    """K9.approx over moduli of mixed bit lengths against the plain version
    with the approximate quotient, and (fully reduced) the exact one."""
    moduli = [_approx_modulus(b) for b in (29, 50, 60, 61)]
    rng = np.random.default_rng(40 + weights)
    n = 4099
    x, y = (torch.stack([torch.stack([torch.stack([
        _rand(rng, (n,), q, cuda) for q in moduli]) for _ in range(2)])
        for _ in range(weights)]) for _ in range(2))
    consts = dyadic_mod.row_constants(tuple(moduli), cuda)
    _build.reset_launches()
    got = dyadic_mod.dyadic(x, y, moduli)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"K9.approx": 1}
    assert torch.equal(got, dyadic_mod.dyadic_plain(x, y, consts, True))
    assert torch.equal(got, dyadic_mod.dyadic_plain(x, y, consts))


@pytest.mark.parametrize("n,bits,kc", [(64, (40, 41, 45), 2),
                                       (1 << 14, (60, 50, 59, 45), 3),
                                       (1 << 15, (29, 50, 59, 49), 2)])
def test_approx_key_switch_kernels_match_plain(cuda, n, bits, kc,
                                               approx_switch):
    """K10.approx and K11.approx against their plain versions with the
    approximate quotients, lazy spread outputs included; the key switch
    with the switch on (mixed bit lengths: the per-row flush) against the
    plain pipeline, with its launches by name."""
    rng = np.random.default_rng(n + 1)
    result, t, keys, moduli, msf = _key_switch_inputs(rng, n, bits, kc,
                                                      cuda)
    ds = len(bits) - 1
    c = ks_mod.constants(tuple(moduli), tuple(msf), ds, cuda)
    tq = torch.stack([_rand(rng, (ds, n), 4 * q, cuda)
                      for q in moduli[:ds] + moduli[-1:]])
    tpp = ks_mod.mac_flush(tq, keys, c, ds, kc, ds + 1, True)
    torch.cuda.synchronize()
    assert torch.equal(tpp, ks_mod.mac_flush_plain(tq, keys, c.mac, ds, kc,
                                                   ds + 1, True))
    assert torch.equal(tpp, ks_mod.mac_flush_plain(tq, keys, c.mac, ds, kc,
                                                   ds + 1))
    x = _rand(rng, (kc, n), 2 * moduli[-1], cuda)
    got = ks_mod.spread(x, c, True)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_mod.spread_plain(x, c, True))
    tntt = torch.stack([_rand(rng, (kc, n), 4 * q, cuda)
                        for q in moduli[:ds]])
    got = ks_mod.fold(result, tpp, tntt, c, True)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_mod.fold_plain(result, tpp, tntt, c, True))
    assert torch.equal(got, ks_mod.fold_plain(result, tpp, tntt, c))
    _build.reset_launches()
    got = key_switch(result, t, n, ds, ds + 1, ds + 1, kc, moduli, keys, msf)
    torch.cuda.synchronize()
    assert _build.launches["K10.approx"] == 1
    assert _build.launches["K11.approx"] == 2
    assert "K10" not in _build.launches and "K11" not in _build.launches
    assert torch.equal(got, ks_mod.key_switch_plain(
        result, t, n, ds, ds + 1, ds + 1, kc, moduli, keys, msf))


@pytest.mark.parametrize("log_n", range(1, 15))
@pytest.mark.parametrize("scheme", ["lean16", "lean8"])
def test_lean_poly_kernel_every_form(cuda, log_n, scheme, monkeypatch):
    """K3 in lean16 and lean8 in every form it takes, against the plain
    lean chain (the approximate mult_mod) and the exact K3."""
    n = 1 << log_n
    q = _approx_modulus(59 if scheme == "lean16" else 61, n)
    plan = get_plan(n, q)
    rng = np.random.default_rng(700 + log_n)
    a, b = (_rand(rng, (3, n), q, cuda) for _ in range(2))
    want = poly.poly_mult_plain(a, b, plan, scheme)
    for form in poly.forms_of(n):
        monkeypatch.setattr(poly, "form_for", lambda *args, f=form: f)
        _build.reset_launches()
        got = poly.poly_mult(a, b, plan, scheme)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {f"{poly.FORMS[form]}.{scheme}": 1}
        assert torch.equal(got, want)
        assert torch.equal(got, poly.poly_mult(a, b, plan))


def test_public_lean_product_goes_through_k3(cuda, approx_switch):
    """poly_mult_mod with the switch on takes the scheme `scheme_for`
    gives into K3: lean16 at 2^14 (q < 2^60), lean8 at 2^12."""
    for n, q_bits, scheme, form in ((1 << 14, 59, "lean16", "K3"),
                                    (1 << 12, 60, "lean8", "K3")):
        q = _approx_modulus(q_bits, n)
        rng = np.random.default_rng(n)
        a, b = (_rand(rng, (4, n), q, cuda) for _ in range(2))
        _build.reset_launches()
        got = poly_mult_mod(a, b, n, q)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {f"{form}.{scheme}": 1}
        assert torch.equal(got, poly.poly_mult_plain(a, b, get_plan(n, q)))


# -- the streaming kernels' edges (K4/K8, the row ops, K10) --------------------

def _strict(kernel, got, want, what):
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{kernel} at {what}"


@pytest.mark.parametrize("q_bits", chip_smoke.EDGE_Q_BITS)
def test_eltwise_kernels_at_their_edges(cuda, q_bits):
    """Every eltwise op (both words where q < 2^30) and every approximate
    instantiation at counts that leave a scalar tail (1, 3, 5, 1023,
    2^22 + 3) and empty, inputs 8 bytes off a 16-byte boundary or not; the
    flat kernel's head with its output so placed."""
    from hexl_tpu_torch import config
    rng = np.random.default_rng(q_bits + 17)
    assert chip_smoke.eltwise_edge_checks(
        rng, cuda, nt, _build, ops, torch_kernels, torch_kernels32,
        to_tensor, config, _strict, q_bits) > 0


def test_row_kernels_at_their_edges(cuda):
    """K4.rows and K8.reduce.rows, exact and approximate, at odd row
    lengths (every other row 8 bytes off), offset inputs and empty rows."""
    from hexl_tpu_torch import config
    assert chip_smoke.rows_edge_checks(
        np.random.default_rng(18), cuda, nt, ops, torch_kernels, to_tensor,
        config, _strict) > 0


@pytest.mark.parametrize("ds", chip_smoke.EDGE_KS_DS)
def test_mac_flush_kernel_at_its_edges(cuda, ds):
    """K10 and K10.approx at every component group size and past one
    group (EDGE_KS_KCS), at odd n and n = 0, with t and the keys 8 bytes
    off a 16-byte boundary."""
    assert chip_smoke.mac_edge_checks(np.random.default_rng(ds), cuda, nt,
                                      ks_mod, to_tensor, _strict, ds) > 0


@pytest.mark.parametrize("kc", [ks_mod.MAC_GROUP + 1,
                                2 * ks_mod.MAC_GROUP + 1])
def test_key_switch_past_one_component_group(cuda, kc):
    """The public key switch at a kc past one of K10's component groups
    (full groups on the grid's z axis, then the one left) goes through
    K10 and matches the plain pipeline."""
    rng = np.random.default_rng(19 + kc)
    n, bits = 64, (40, 41, 45)
    result, t, keys, moduli, msf = _key_switch_inputs(rng, n, bits, kc,
                                                      cuda)
    _build.reset_launches()
    got = key_switch(result, t, n, 2, 3, 3, kc, moduli, keys, msf)
    torch.cuda.synchronize()
    assert _build.launches["K10"] >= 1
    assert torch.equal(got, ks_mod.key_switch_plain(
        result, t, n, 2, 3, 3, kc, moduli, keys, msf))
