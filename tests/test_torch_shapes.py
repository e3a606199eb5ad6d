"""The port keeps the JAX package's operand shapes: 0-d operands stay 0-d,
vector operands broadcast against each other, and shapes that do not
broadcast are refused.

Each case sends the same numpy inputs through `hexl_tpu` and
`hexl_tpu_torch` (device="cpu") and requires bit-equal values and equal
shapes.
"""

import functools

import numpy as np
import pytest
import torch

import hexl_tpu.eltwise as jax_eltwise
import hexl_tpu.poly as jax_poly
from hexl_tpu import nt as jnt
import hexl_tpu_torch
from hexl_tpu_torch.limb import to_numpy, to_tensor

from torch_threads import one_torch_thread  # noqa: F401

Q_BITS = (20, 50)   # the single-word regime (q < 2^30) and the 64-bit one


@functools.lru_cache(maxsize=None)
def _modulus(q_bits, n=1024):
    return jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]


def _rand(rng, shape, bound):
    return rng.integers(0, bound, size=shape, dtype=np.uint64)


def _same(name, *args, jax_module=jax_eltwise, **kwargs):
    got = getattr(hexl_tpu_torch, name)(*args, device="cpu", **kwargs)
    want = np.asarray(getattr(jax_module, name)(*args, **kwargs))
    assert isinstance(got, np.ndarray) and got.dtype == np.uint64
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


# Each public eltwise op with its arguments around the vector operands
# (bound below which the operands are drawn, as a multiple of q).
ZERO_D_CASES = {
    "add": ("eltwise_add_mod", 2, lambda q: (q,)),
    "add_scalar": ("eltwise_add_mod", 1, lambda q: (5, q)),
    "sub": ("eltwise_sub_mod", 2, lambda q: (q,)),
    "sub_scalar": ("eltwise_sub_mod", 1, lambda q: (5, q)),
    "mult": ("eltwise_mult_mod", 2, lambda q: (q,)),
    "mult_imf4": ("eltwise_mult_mod", 2, lambda q: (q, 4)),
    "fma": ("eltwise_fma_mod", 1, lambda q: (7, None, q)),
    "reduce_imf2": ("eltwise_reduce_mod", 1, lambda q: (q, 2, 1)),
    "reduce_imfq": ("eltwise_reduce_mod", 1, lambda q: (q, q, 1)),
    "cmp_add": ("eltwise_cmp_add", 1, lambda q: ("lt", q // 2, 3)),
    "cmp_sub_mod": ("eltwise_cmp_sub_mod", 1, lambda q: (q, "nle", q // 2,
                                                           3)),
    "mont_in": ("eltwise_montgomery_form_in", 1, lambda q: (q,)),
    "mont_out": ("eltwise_montgomery_form_out", 1, lambda q: (q,)),
    "mont_mult": ("eltwise_montgomery_mult_reduce", 2, lambda q: (q,)),
}


@pytest.mark.parametrize("q_bits", Q_BITS)
@pytest.mark.parametrize("case", sorted(ZERO_D_CASES))
def test_zero_d_operands_stay_zero_d(case, q_bits):
    """A 0-d numpy operand gives a 0-d result, as in the JAX package."""
    name, vectors, rest = ZERO_D_CASES[case]
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits)
    ops = [np.array(int(_rand(rng, (), q)), np.uint64)
           for _ in range(vectors)]
    extra = rest(q)
    if name == "eltwise_fma_mod":   # arg1, arg2 (scalar), arg3, q
        _same(name, ops[0], *extra)
        _same(name, ops[0], extra[0], np.array(3, np.uint64), q)
        return
    if case.endswith("_scalar"):
        _same(name, ops[0], *extra)
        return
    _same(name, *ops, *extra)


def test_zero_d_tensor_stays_zero_d():
    """A 0-d int64 tensor gives a 0-d tensor."""
    q = _modulus(50)
    a, b = to_tensor(np.uint64(3), "cpu"), to_tensor(np.uint64(q - 1), "cpu")
    assert a.shape == ()
    out = hexl_tpu_torch.eltwise_add_mod(a, b, q)
    assert isinstance(out, torch.Tensor) and out.shape == ()
    assert int(to_numpy(out)) == 2
    out = hexl_tpu_torch.eltwise_mult_mod(a, b, q)
    assert out.shape == () and int(to_numpy(out)) == q - 3


# (name, vectors, rest): the ops that take two vector operands.
BROADCAST_OPS = {
    "add": ("eltwise_add_mod", lambda a, b, q: (a, b, q)),
    "sub": ("eltwise_sub_mod", lambda a, b, q: (a, b, q)),
    "mult": ("eltwise_mult_mod", lambda a, b, q: (a, b, q)),
    "fma": ("eltwise_fma_mod", lambda a, b, q: (a, 11, b, q)),
    "mont_mult": ("eltwise_montgomery_mult_reduce", lambda a, b, q: (a, b,
                                                                      q)),
}
BROADCAST_SHAPES = (((3, 16), (16,)), ((16,), (3, 16)), ((3, 1), (16,)),
                    ((2, 3, 16), (3, 16)), ((3, 16), ()))


@pytest.mark.parametrize("q_bits", Q_BITS)
@pytest.mark.parametrize("shapes", BROADCAST_SHAPES, ids=str)
@pytest.mark.parametrize("op", sorted(BROADCAST_OPS))
def test_vector_operands_broadcast(op, shapes, q_bits):
    name, args = BROADCAST_OPS[op]
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits + len(shapes[0]))
    a, b = (_rand(rng, s, q) for s in shapes)
    _same(name, *args(a, b, q))


@pytest.mark.parametrize("q_bits", Q_BITS)
def test_int_operand_broadcasts(q_bits):
    """mult_mod with an int b, which the JAX op takes as an array."""
    q = _modulus(q_bits)
    a = _rand(np.random.default_rng(1), (3, 16), q)
    _same("eltwise_mult_mod", a, 3, q)
    _same("eltwise_mult_mod", a, q - 1, q)


@pytest.mark.parametrize("op", sorted(BROADCAST_OPS))
def test_shapes_that_do_not_broadcast_are_refused(op):
    name, args = BROADCAST_OPS[op]
    q = _modulus(50)
    rng = np.random.default_rng(2)
    a, b = _rand(rng, (3, 16), q), _rand(rng, (4, 16), q)
    with pytest.raises(TypeError):
        getattr(jax_eltwise, name)(*args(a, b, q))
    with pytest.raises(ValueError, match="do not broadcast"):
        getattr(hexl_tpu_torch, name)(*args(a, b, q), device="cpu")


# Every degree of the one-launch product (2 .. 2048 here), and one of the
# staged route above 2^14.
POLY_DEGREES = [1 << k for k in range(1, 12)] + [1 << 15]


@pytest.mark.parametrize("n", POLY_DEGREES)
def test_poly_mult_broadcasts_one_operand(n):
    """(3, n) x (n,): many polynomials times one plaintext; also (n,) x
    (3, n) and (2, 1, n) x (3, n) at two small degrees (each shape is a
    JAX compile)."""
    q = _modulus(50, n)
    rng = np.random.default_rng(n)
    a, b = _rand(rng, (3, n), q), _rand(rng, (n,), q)
    _same("poly_mult_mod", a, b, n, q, jax_module=jax_poly)
    if n in (2, 64):
        _same("poly_mult_mod", b, a, n, q, jax_module=jax_poly)
        _same("poly_mult_mod", _rand(rng, (2, 1, n), q), a, n, q,
              jax_module=jax_poly)


def test_poly_mult_refuses_shapes_that_do_not_broadcast():
    n = 16
    q = _modulus(50, n)
    rng = np.random.default_rng(3)
    a, b = _rand(rng, (3, n), q), _rand(rng, (2, n), q)
    with pytest.raises(TypeError):
        jax_poly.poly_mult_mod(a, b, n, q)
    with pytest.raises(ValueError, match="do not broadcast"):
        hexl_tpu_torch.poly_mult_mod(a, b, n, q, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        hexl_tpu_torch.poly_mult_mod(a, b[:, :1], n, q, device="cpu")


def test_rns_poly_mult_broadcasts_within_each_prime():
    """(k, 3, n) x (k, n): each prime's rows broadcast, as in the JAX
    stacked pipeline; a leading axis other than the basis is refused."""
    n = 64
    moduli = jnt.generate_primes(2, 50, True, ntt_size=n)
    rng = np.random.default_rng(4)
    a = np.stack([_rand(rng, (3, n), q) for q in moduli])
    for b in (np.stack([_rand(rng, (n,), q) for q in moduli]),
              np.stack([_rand(rng, (1, n), q) for q in moduli])):
        _same("rns_poly_mult_mod", a, b, n, moduli, jax_module=jax_poly)
    with pytest.raises(ValueError):
        hexl_tpu_torch.rns_poly_mult_mod(a, a[:1], n, moduli, device="cpu")
