"""The port's element-wise family (plain versions, CPU) against hexl_tpu's.

Every public op of `hexl_tpu_torch` with device="cpu" against the same op
of `hexl_tpu.eltwise` on the same numpy inputs from a seed, bit for bit:
q at 20, 29, 49, 60 and 61 bits (generate_primes gives q in (2^b,
2^(b+1))) and the largest prime below 2^62 ("62"), wherever the op takes
that q; the IMF/OMF matrix, lazy reduce_mod outputs included; vector and
scalar forms; all eight predicates with values and bounds on both sides
of 2^63; the Montgomery family. The single-word plain bodies are held
against `jnp_kernels32`'s, and a chain of ops against the TPU runner
`run_eltwise` in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

import hexl_tpu.eltwise as jax_eltwise
from hexl_tpu import nt as jnt
from hexl_tpu.eltwise import jnp_kernels as JK
from hexl_tpu.eltwise import jnp_kernels32 as JK32
from hexl_tpu.limb import from_limbs, to_limbs
import hexl_tpu_torch
from hexl_tpu_torch.eltwise import torch_kernels as K
from hexl_tpu_torch.eltwise import torch_kernels32 as K32
from hexl_tpu_torch.limb import to_numpy, to_tensor

Q_BITS = [20, 29, 49, 60, 61, 62]
SIZE = 1031
CMPS = ("eq", "lt", "le", "false", "ne", "nlt", "nle", "true")
XEON_MONT_MODULUS = 67280421310725   # the Xeon reference's Montgomery row


@functools.lru_cache(maxsize=None)
def _modulus(q_bits):
    if q_bits == 62:
        return jnt.generate_primes(1, 61, False)[0]
    return jnt.generate_primes(1, q_bits, True)[0]


def _u64(rng, lo, hi, size=None):
    """Uniform u64 in [lo, hi); hi may be 2^64."""
    return rng.integers(lo, hi - 1, size=size, dtype=np.uint64,
                        endpoint=True)


def _same(port_fn, jax_fn, *args, **kwargs):
    got = getattr(hexl_tpu_torch, port_fn)(*args, device="cpu", **kwargs)
    want = np.asarray(getattr(jax_eltwise, jax_fn)(*args, **kwargs))
    assert isinstance(got, np.ndarray) and got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q_bits", Q_BITS)
def test_add_sub_vs_jax(q_bits):
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits)
    a, b = _u64(rng, 0, q, SIZE), _u64(rng, 0, q, SIZE)
    s = int(_u64(rng, 0, q))
    for name in ("eltwise_add_mod", "eltwise_sub_mod"):
        _same(name, name, a, b, q)
        _same(name, name, a, s, q)


MULT_CASES = [(b, imf) for b in Q_BITS for imf in (1, 2, 4)]


@pytest.mark.parametrize("q_bits,imf", MULT_CASES)
def test_mult_mod_vs_jax(q_bits, imf):
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits * 10 + imf)
    a, b = (_u64(rng, 0, imf * q, SIZE) for _ in range(2))
    _same("eltwise_mult_mod", "eltwise_mult_mod", a, b, q, imf)


# IMF 8 needs 8q < 2^64, so q < 2^61: not the 61-bit q nor the top one.
FMA_CASES = [(b, imf) for b in Q_BITS for imf in (1, 2, 4, 8)
             if imf < 8 or b < 61]


@pytest.mark.parametrize("q_bits,imf", FMA_CASES)
def test_fma_mod_vs_jax(q_bits, imf):
    """With and without the addend; the scalar is preconditioned at 2^32
    in the single-word regime, at 2^64 otherwise."""
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits * 10 + imf)
    a, c = (_u64(rng, 0, imf * q, SIZE) for _ in range(2))
    w = int(_u64(rng, 0, imf * q))
    _same("eltwise_fma_mod", "eltwise_fma_mod", a, w, c, q, imf)
    _same("eltwise_fma_mod", "eltwise_fma_mod", a, w, None, q, imf)


@pytest.mark.parametrize("q_bits", Q_BITS)
def test_reduce_mod_vs_jax(q_bits):
    """IMF in {2, 4, q} to OMF in {1, 2}, lazy outputs bit for bit; at
    IMF = q the input is any u64."""
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits)
    for imf, omf in ((q, 1), (q, 2), (2, 1), (4, 1), (4, 2), (2, 2)):
        x = _u64(rng, 0, 1 << 64 if imf == q else imf * q, SIZE)
        _same("eltwise_reduce_mod", "eltwise_reduce_mod", x, q, imf, omf)


@pytest.mark.parametrize("cmp", CMPS)
def test_cmp_vs_jax(cmp):
    """Unsigned predicates: values and bounds on both sides of 2^63, some
    values equal to the bound; diff wraps in cmp_add."""
    rng = np.random.default_rng(CMPS.index(cmp))
    a = _u64(rng, 0, 1 << 64, SIZE)
    for bound in (int(_u64(rng, 0, 1 << 63)), int(_u64(rng, 1 << 63, 1 << 64))):
        a[:9] = bound
        a[9:12] = bound + 1 if bound + 1 < (1 << 64) else 0
        diff = int(_u64(rng, 1, 1 << 64))
        _same("eltwise_cmp_add", "eltwise_cmp_add", a, cmp, bound, diff)
        for q_bits in (49, 62):
            q = _modulus(q_bits)
            d = int(_u64(rng, 1, q))
            _same("eltwise_cmp_sub_mod", "eltwise_cmp_sub_mod", a, q, cmp,
                  bound, d)


@pytest.mark.parametrize("q_bits", Q_BITS + ["xeon"])
def test_montgomery_vs_jax(q_bits):
    q = XEON_MONT_MODULUS if q_bits == "xeon" else _modulus(q_bits)
    rng = np.random.default_rng(7)
    a, b = _u64(rng, 0, q, SIZE), _u64(rng, 0, q, SIZE)
    _same("eltwise_montgomery_form_in", "eltwise_montgomery_form_in", a, q)
    _same("eltwise_montgomery_form_out", "eltwise_montgomery_form_out", a, q)
    _same("eltwise_montgomery_mult_reduce",
          "eltwise_montgomery_mult_reduce", a, b, q)


@pytest.mark.parametrize("q_bits", [20, 29])
def test_single_word_bodies_vs_jnp_kernels32(q_bits):
    """The port's single-word plain bodies against jnp_kernels32's, and
    against the port's own 64-bit bodies, on in-range inputs."""
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits)
    t = lambda v: to_tensor(v, "cpu")
    j = lambda v: to_limbs(v)

    def same(got, want, also=None):
        np.testing.assert_array_equal(to_numpy(got), from_limbs(want))
        if also is not None:
            np.testing.assert_array_equal(to_numpy(got), to_numpy(also))

    a, b = _u64(rng, 0, q, SIZE), _u64(rng, 0, q, SIZE)
    same(K32.add_mod32(t(a), t(b), q), JK32.add_mod32(j(a), j(b), q),
         K.add_mod(t(a), t(b), q))
    same(K32.sub_mod32(t(a), t(b), q), JK32.sub_mod32(j(a), j(b), q),
         K.sub_mod(t(a), t(b), q))
    for imf in (1, 2, 4):
        x, y = _u64(rng, 0, imf * q, SIZE), _u64(rng, 0, imf * q, SIZE)
        same(K32.mult_mod32(t(x), t(y), q, imf),
             JK32.mult_mod32(j(x), j(y), q, imf),
             K.mult_mod(t(x), t(y), q, imf))
    for imf in (1, 2, 4, 8):
        x, c = _u64(rng, 0, imf * q, SIZE), _u64(rng, 0, imf * q, SIZE)
        w = jnt.reduce_mod(int(_u64(rng, 0, imf * q)), q, imf)
        wp32 = jnt.barrett_factor(w, 32, q)
        wp64 = jnt.barrett_factor(w, 64, q)
        for cc in (c, None):
            same(K32.fma_mod32_preconned(t(x), w, wp32,
                                         None if cc is None else t(cc), q,
                                         imf),
                 JK32.fma_mod32_preconned(j(x), j(np.uint64(w)),
                                          j(np.uint64(wp32)),
                                          None if cc is None else j(cc), q,
                                          imf),
                 K.fma_mod_preconned(t(x), w, wp64,
                                     None if cc is None else t(cc), q, imf))
    for imf, omf in ((2, 1), (4, 1), (4, 2), (2, 2), (q, 1), (q, 2)):
        x = _u64(rng, 0, min(imf * q, 1 << 32), SIZE)
        same(K32.reduce_mod32(t(x), q, imf, omf),
             JK32.reduce_mod32(j(x), q, imf, omf))


def test_chain_vs_pallas_runner(monkeypatch):
    """a*b + c*d mod q through the port's public ops, against the TPU
    runner run_eltwise fusing the same chain in interpret mode (as
    tests/test_eltwise.py runs it)."""
    from jax.experimental import pallas as pl
    from hexl_tpu.eltwise import pallas_kernels as P

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    q = jnt.generate_primes(1, 60, True, ntt_size=1 << 10)[0]
    rng = np.random.default_rng(11)
    a, b, c, d = (rng.integers(0, q, size=(3, 300), dtype=np.uint64)
                  for _ in range(4))

    def mac(x, y, z, w):
        return JK.add_mod(JK.mult_mod(x, y, q, 1), JK.mult_mod(z, w, q, 1), q)

    want = from_limbs(P.run_eltwise(mac, tuple(to_limbs(v)
                                               for v in (a, b, c, d))))
    ab = hexl_tpu_torch.eltwise_mult_mod(a, b, q, device="cpu")
    cd = hexl_tpu_torch.eltwise_mult_mod(c, d, q, device="cpu")
    np.testing.assert_array_equal(
        hexl_tpu_torch.eltwise_add_mod(ab, cd, q, device="cpu"), want)


def test_tensors_in_tensors_out():
    """int64 tensors of u64 bits give a tensor on their device; numpy
    gives numpy."""
    q = _modulus(49)
    rng = np.random.default_rng(3)
    a = _u64(rng, 0, q, 64)
    ta = to_tensor(a, "cpu")
    got = hexl_tpu_torch.eltwise_fma_mod(ta, 5, ta, q, 1)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(
        to_numpy(got), hexl_tpu_torch.eltwise_fma_mod(a, 5, a, q, 1,
                                                      device="cpu"))
    got = hexl_tpu_torch.eltwise_cmp_add(ta, "nlt", 1 << 63, 3)
    assert isinstance(got, torch.Tensor)


def test_debug_checks_match_jax(monkeypatch):
    """With HEXL_TPU_DEBUG=1 the port validates as the JAX package does,
    with the same messages; without it, nothing is checked."""
    q = _modulus(49)
    big = np.array([q, 1], dtype=np.uint64)
    ok = np.array([1, 2], dtype=np.uint64)
    calls = [
        ("eltwise_add_mod", (big, ok, q)),
        ("eltwise_sub_mod", (ok, q + 5, q)),
        ("eltwise_mult_mod", (ok, ok, q, 3)),
        ("eltwise_fma_mod", (ok, 8 * q, None, q, 8)),
        ("eltwise_reduce_mod", (ok, q, 2, 2)),
        ("eltwise_cmp_add", (ok, "lt", 5, 0)),
        ("eltwise_cmp_sub_mod", (ok, 1, "lt", 5, 3)),
        ("eltwise_montgomery_form_in", (ok, q + 1)),
        ("eltwise_montgomery_form_out", (big, q)),
        ("eltwise_montgomery_mult_reduce", (ok, big, q)),
    ]
    monkeypatch.setenv("HEXL_TPU_DEBUG", "1")
    for name, args in calls:
        with pytest.raises(ValueError) as want:
            getattr(jax_eltwise, name)(*args)
        with pytest.raises(ValueError, match=str(want.value).replace(
                "^", r"\^").replace("*", r"\*")):
            getattr(hexl_tpu_torch, name)(*args, device="cpu")
    monkeypatch.setenv("HEXL_TPU_DEBUG", "0")
    hexl_tpu_torch.eltwise_add_mod(big, ok, q, device="cpu")
