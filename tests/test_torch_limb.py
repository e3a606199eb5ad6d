"""The port's 64-bit vocabulary and number theory against the JAX package.

`hexl_tpu_torch.limb` (int64 tensors carrying u64 bits) against the NumPy
oracle `hexl_tpu.ref` and the JAX limb functions; `hexl_tpu_torch.nt`
against `hexl_tpu.nt`. Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from hexl_tpu import limb as jlimb
from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu_torch import limb, nt

U64_EDGES = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
             (1 << 63) + 1, (1 << 64) - 2, (1 << 64) - 1]


def _edge_and_random(seed, size=4000):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 64, size=size, dtype=np.uint64,
                        endpoint=False)
    edges = np.array(U64_EDGES, dtype=np.uint64)
    a = np.concatenate([np.repeat(edges, len(edges)), rand])
    b = np.concatenate([np.tile(edges, len(edges)), rand[::-1].copy()])
    return a, b


def _t(a):
    return limb.to_tensor(a, "cpu")


def _moduli(q_bits):
    return nt.generate_primes(1, q_bits, True, ntt_size=1 << 10)[0]


def test_tensor_conversion_round_trip():
    a, _ = _edge_and_random(0, 100)
    t = _t(a)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(limb.to_numpy(t), a)
    assert limb.s64((1 << 64) - 1) == -1
    assert limb.s64(5) == 5
    with pytest.raises(ValueError):
        limb.s64(1 << 64)


@pytest.mark.parametrize("seed", [1, 2])
def test_mulhi_mullo_vs_ref(seed):
    a, b = _edge_and_random(seed)
    np.testing.assert_array_equal(limb.to_numpy(limb.mulhi64(_t(a), _t(b))),
                                  ref.mulhi64(a, b))
    np.testing.assert_array_equal(limb.to_numpy(limb.mullo64(_t(a), _t(b))),
                                  ref.mullo64(a, b))
    hi, lo = limb.mul64_wide(_t(a), _t(b))
    for i in range(0, len(a), 97):
        p = int(a[i]) * int(b[i])
        assert int(limb.to_numpy(hi)[i]) == p >> 64
        assert int(limb.to_numpy(lo)[i]) == p & ((1 << 64) - 1)


@pytest.mark.parametrize("s", [0, 1, 13, 31, 32, 33, 60, 63])
def test_shifts(s):
    a, b = _edge_and_random(3, 500)
    got = limb.to_numpy(limb.shr64(_t(a), s))
    np.testing.assert_array_equal(got, a >> np.uint64(s))
    for shift in (s, s + 64):
        got = limb.to_numpy(limb.shr128_to64(_t(a), _t(b), shift))
        want = [((int(x) << 64 | int(y)) >> shift) & ((1 << 64) - 1)
                for x, y in zip(a, b)]
        np.testing.assert_array_equal(got, np.array(want, dtype=np.uint64))


@pytest.mark.parametrize("q_bits", [30, 50, 60, 61])
def test_halver_and_lazy_reduction_vs_ref(q_bits):
    q = _moduli(q_bits)
    rng = np.random.default_rng(q_bits)
    for imf in (1, 2, 4):
        x = np.concatenate([
            rng.integers(0, imf * q, size=2000, dtype=np.uint64),
            np.array([0, q - 1, q, 2 * q - 1, imf * q - 1], dtype=np.uint64)
            % np.uint64(imf * q)])
        np.testing.assert_array_equal(
            limb.to_numpy(limb.reduce_mod_lazy64(_t(x), q, imf)),
            ref.reduce_mod_lazy(x, q, imf))
    x = rng.integers(0, 2 * q, size=2000, dtype=np.uint64)
    want = np.where(x >= np.uint64(q), x - np.uint64(q), x)
    np.testing.assert_array_equal(
        limb.to_numpy(limb.cond_sub64_half(_t(x), q)), want)
    with pytest.raises(ValueError):
        limb.reduce_mod_lazy64(_t(x), q, 3)


@pytest.mark.parametrize("q_bits", [30, 50, 60, 61])
def test_shoup_vs_ref(q_bits):
    q = _moduli(q_bits)
    rng = np.random.default_rng(q_bits + 1)
    x, _ = _edge_and_random(q_bits)
    for w in (0, 1, q - 1, int(rng.integers(0, q))):
        wp = jnt.barrett_factor(w, 64, q)
        got = limb.shoup_mul_lazy(_t(x), limb.s64(w), limb.s64(wp), q)
        want = ref.multiply_mod_lazy(x, w, wp, q)
        np.testing.assert_array_equal(limb.to_numpy(got), want)
        assert (limb.to_numpy(got) < np.uint64(2 * q)).all()


@pytest.mark.parametrize("q_bits", [30, 50, 60, 61])
@pytest.mark.parametrize("omf", [1, 2])
def test_barrett_reduce_vs_ref(q_bits, omf):
    q = _moduli(q_bits)
    x, _ = _edge_and_random(q_bits + 7)
    q_barr = jnt.barrett_factor(1, 64, q)
    got = limb.barrett_reduce_u64(_t(x), q, q_barr, omf)
    np.testing.assert_array_equal(limb.to_numpy(got),
                                  ref.barrett_reduce_64(x, q, q_barr, omf))


@pytest.mark.parametrize("q_bits", [3, 30, 50, 60, 61])
def test_mult_mod_barrett_vs_jax_and_bigint(q_bits):
    q = jnt.generate_primes(1, q_bits, True)[0] if q_bits > 3 else 3
    rng = np.random.default_rng(q_bits + 11)
    x = np.concatenate([rng.integers(0, q, size=3000, dtype=np.uint64),
                        np.array([0, 1, q - 1], dtype=np.uint64)])
    y = np.concatenate([rng.integers(0, q, size=3000, dtype=np.uint64),
                        np.array([q - 1, q - 1, q - 1], dtype=np.uint64)])
    got = limb.to_numpy(limb.mult_mod_barrett(_t(x), _t(y), q))
    np.testing.assert_array_equal(
        got, ((x.astype(object) * y.astype(object)) % q).astype(np.uint64))
    jax_out = jlimb.from_limbs(jlimb.mult_mod_barrett(
        jlimb.to_limbs(x), jlimb.to_limbs(y), q))
    np.testing.assert_array_equal(got, jax_out)


@pytest.mark.parametrize("bits,ntt_size,small", [
    (20, 1 << 10, True), (30, 1 << 12, True), (50, 1 << 14, True),
    (60, 1 << 14, True), (61, 1 << 14, True), (45, 1 << 8, False),
    (59, 1 << 16, False)])
def test_nt_generate_primes_vs_jax(bits, ntt_size, small):
    assert (nt.generate_primes(3, bits, small, ntt_size)
            == jnt.generate_primes(3, bits, small, ntt_size))


@pytest.mark.parametrize("bits,log_n", [(20, 3), (30, 10), (50, 12),
                                        (60, 14), (61, 14)])
def test_nt_roots_inverses_factors_vs_jax(bits, log_n):
    n = 1 << log_n
    q = jnt.generate_primes(1, bits, True, ntt_size=n)[0]
    assert nt.is_prime(q) and jnt.is_prime(q)
    assert nt.is_prime(q + 2) == jnt.is_prime(q + 2)
    assert (nt.minimal_primitive_root(2 * n, q)
            == jnt.minimal_primitive_root(2 * n, q))
    rng = np.random.default_rng(bits)
    for v in [1, 2, q - 1] + [int(r) for r in rng.integers(1, q, size=5)]:
        assert nt.inverse_mod(v, q) == jnt.inverse_mod(v, q)
        for shift in (32, 52, 64):
            assert (nt.barrett_factor(v, shift, q)
                    == jnt.barrett_factor(v, shift, q))
    assert nt.reverse_bits(5, log_n) == jnt.reverse_bits(5, log_n)
    assert nt.log2_exact(n) == log_n
    with pytest.raises(ValueError):
        nt.inverse_mod(q, q)
    with pytest.raises(ValueError):
        nt.log2_exact(n + 1)


def test_nt_is_prime_matches_jax():
    for v in list(range(0, 400)) + [(1 << 61) - 1, (1 << 62) - 57,
                                    (1 << 62) - 55, 2 ** 64 - 59]:
        assert nt.is_prime(v) == jnt.is_prime(v), v


@pytest.mark.parametrize("seed", [0, 1])
def test_unsigned_compares_and_select_vs_jax(seed):
    """lt/le/ge/gt/eq on u64 bits across 2^63 (torch's own are signed),
    against the JAX limb compares, with tensor and scalar right sides."""
    a, b = _edge_and_random(seed, 2000)
    ja, jb = jlimb.to_limbs(a), jlimb.to_limbs(b)
    for ours, theirs in ((limb.lt64, jlimb.lt64), (limb.le64, jlimb.le64),
                         (limb.ge64, jlimb.ge64), (limb.gt64, jlimb.gt64),
                         (limb.eq64, jlimb.eq64)):
        want = np.asarray(theirs(ja, jb))
        np.testing.assert_array_equal(ours(_t(a), _t(b)).numpy(), want)
        for s in (5, (1 << 63) + 5):
            want = np.asarray(theirs(ja, jlimb.const64(s, a.shape)))
            np.testing.assert_array_equal(ours(_t(a), s).numpy(), want)
    mask = limb.lt64(_t(a), _t(b))
    np.testing.assert_array_equal(
        limb.to_numpy(limb.select64(mask, _t(a), _t(b))), np.minimum(a, b))


def test_add128_and_montgomery_reduce_vs_jax():
    """The 128-bit add wraps mod 2^128; REDC's carry is an unsigned
    compare."""
    a, b = _edge_and_random(2, 2000)
    c, d = _edge_and_random(3, 2000)
    hi, lo = limb.add128(_t(a), _t(b), _t(c), _t(d))
    got = [(int(h) << 64) | int(x) for h, x in
           zip(limb.to_numpy(hi), limb.to_numpy(lo))]
    want = [(((int(w) << 64) | int(x)) + ((int(y) << 64) | int(z)))
            % (1 << 128) for w, x, y, z in zip(a, b, c, d)]
    assert got == want
    for q_bits in (30, 50, 61):
        q = _moduli(q_bits)
        inv = nt.hensel_lemma_2adic_root(64, q)
        assert inv == jnt.hensel_lemma_2adic_root(64, q)
        t_hi = a % np.uint64(q)          # t = t_hi 2^64 + t_lo < 2^64 q
        got = limb.montgomery_reduce_u128(_t(t_hi), _t(b), q, inv)
        want = jlimb.montgomery_reduce_u128(
            jlimb.U128(jlimb.to_limbs(t_hi), jlimb.to_limbs(b)), q, 64, inv)
        np.testing.assert_array_equal(limb.to_numpy(got),
                                      jlimb.from_limbs(want))
        for t in ((int(t_hi[0]) << 64) | int(b[0]),
                  (int(t_hi[-1]) << 64) | int(b[-1])):
            assert nt.montgomery_reduce(t, q, 64, inv) == \
                jnt.montgomery_reduce(t, q, 64, inv)


def test_mult_mod_barrett_rows_vs_jax_traced():
    """Per-row (q, mu, shift) tensors over rows of mixed bit lengths, down
    to q = 3 (shift 0), against mult_mod_barrett_traced row by row."""
    moduli = [3, 5, _moduli(20), _moduli(40), _moduli(50), _moduli(61)]
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, q, 500, dtype=np.uint64) for q in moduli])
    y = np.stack([rng.integers(0, q, 500, dtype=np.uint64) for q in moduli])
    consts = np.array([moduli] + [list(v) for v in zip(
        *(nt.barrett_mult_constants(q) for q in moduli))], dtype=np.uint64)
    q_t, mu_t, shift_t = (_t(consts[k][:, None]) for k in range(3))
    got = limb.to_numpy(limb.mult_mod_barrett_rows(_t(x), _t(y), q_t, mu_t,
                                                   shift_t))
    for i, q in enumerate(moduli):
        mu, shift = nt.barrett_mult_constants(q)
        want = jlimb.mult_mod_barrett_traced(
            jlimb.to_limbs(x[i]), jlimb.to_limbs(y[i]), jlimb.const64(q),
            jlimb.const64(2 * q), jlimb.const64(mu), shift, False)
        np.testing.assert_array_equal(got[i], jlimb.from_limbs(want))


@pytest.mark.parametrize("q_bits", [20, 49, 61])
def test_nt_reductions_vs_jax(q_bits):
    q = _moduli(q_bits)
    barr = nt.barrett_factor(1, 64, q)
    rng = np.random.default_rng(q_bits)
    for x in [int(v) for v in rng.integers(0, 1 << 64, 50, dtype=np.uint64)]:
        for omf in (1, 2):
            assert nt.barrett_reduce_64(x, q, barr, omf) == \
                jnt.barrett_reduce_64(x, q, barr, omf)
        for imf in (1, 2, 4, 8):
            v = x % (imf * q)
            assert nt.reduce_mod(v, q, imf) == jnt.reduce_mod(v, q, imf)
    assert nt.multiply_mod(q - 1, q - 2, q) == jnt.multiply_mod(q - 1, q - 2,
                                                                q)
    assert nt.pow_mod(3, q - 2, q) == jnt.pow_mod(3, q - 2, q)
