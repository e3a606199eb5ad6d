"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip without a card.
Run them on the GPU machine with `pytest -m gpu tests/test_torch_gpu.py`.
Whether a card is present is decided in the fixture, never at import, so
that every test worker collects the same tests.
"""

import numpy as np
import pytest
import torch

from hexl_tpu_torch import (NTT, _build, eltwise_mult_mod, nt, poly_mult_mod,
                            rns_poly_mult_mod)
from hexl_tpu_torch import poly
from hexl_tpu_torch.eltwise import ops, torch_kernels
from hexl_tpu_torch.limb import to_tensor
from hexl_tpu_torch.ntt import cuda_ntt, get_plan, hier, ntt32, torch_ntt

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
    for word in ((64, 32) if q_bits < 30 else (64,)):
        for omf in (1, 4):
            x = _rand(rng, (batch, n), 4 * q, cuda)
            got = hier.cross(x, plan, True, omf, word)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.cross_fwd_plain(x, plan, word))
            got = hier.local(x, plan, True, omf, word)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.local_fwd_plain(x, plan, omf, word))
        for omf in (1, 2):
            x = _rand(rng, (batch, n), 2 * q, cuda)
            got = hier.local(x, plan, False, omf, word)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.local_inv_plain(x, plan, word))
            got = hier.cross(x, plan, False, omf, word)
            torch.cuda.synchronize()
            assert torch.equal(got, hier.cross_inv_plain(x, plan, omf, word))


@pytest.mark.parametrize("n,batch", [(1 << 10, 401), (1 << 15, 3)])
def test_single_word_kernel_matches_plain(cuda, n, batch):
    """K7 against the plain single-word walk."""
    q = nt.generate_primes(1, 29, True, ntt_size=n)[0]
    plan = get_plan(n, q)
    rng = np.random.default_rng(n)
    for imf, omf in ((1, 1), (4, 4), (2, 1)):
        x = _rand(rng, (batch, n), imf * q, cuda)
        got = cuda_ntt.fwd_ntt(x, plan, imf, omf, word=32)
        torch.cuda.synchronize()
        assert torch.equal(got, ntt32.fwd_ntt32(x, plan, imf, omf))
    for imf, omf in ((1, 1), (2, 2)):
        x = _rand(rng, (batch, n), imf * q, cuda)
        got = cuda_ntt.inv_ntt(x, plan, imf, omf, word=32)
        torch.cuda.synchronize()
        assert torch.equal(got, ntt32.inv_ntt32(x, plan, imf, omf))


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
    assert dict(_build.launches) == {"K1": 2, "K3": 1, "K4": 1}
    big = rng.integers(0, q, size=(4096, n), dtype=np.uint64)
    np.testing.assert_array_equal(engine.inverse(engine.forward(big)), big)
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
