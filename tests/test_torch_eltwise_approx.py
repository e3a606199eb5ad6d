"""The eltwise family's approximate quotients in the port against the JAX
package's, bit for bit, lazy outputs included.

`hexl_tpu/eltwise/jnp_kernels.py` switches five 64-bit bodies to
`mulhi64_approx` (error at most 1) where `config.approx_butterflies()` is
on (`_approx()`): mult_mod, fma_mod, reduce_mod, cmp_sub_mod and
montgomery_form_in. Held here, with the switch forced on both sides (the
port's `config.approx_butterflies(device)` and the JAX package's): the
four limb functions against `hexl_tpu.limb`; the port's tensor-level
wrappers (`eltwise.ops`, whose plain bodies run on the CPU) against the
JAX bodies at every IMF/OMF for q of 20 to 61 bits and the largest prime
below 2^62 wherever the op takes that q, the row forms against each row's
JAX op, and the public ops against `hexl_tpu.eltwise`'s. The JAX bodies
run eagerly (no compile per modulus); the public ops jit.
"""

import functools

import numpy as np
import pytest
import torch

import hexl_tpu.eltwise as jax_eltwise
import hexl_tpu_torch
import hexl_tpu_torch.config as port_config
from hexl_tpu import config as jax_config
from hexl_tpu import limb as jlimb
from hexl_tpu import nt as jnt
from hexl_tpu.eltwise import jnp_kernels as JK
from hexl_tpu.limb import from_limbs, to_limbs
from hexl_tpu_torch import limb
from hexl_tpu_torch.eltwise import ops
from hexl_tpu_torch.limb import to_numpy, to_tensor

Q_BITS = [20, 29, 49, 60, 61, 62]
SIZE = 1031
CMPS = ("eq", "lt", "le", "false", "ne", "nlt", "nle", "true")


@functools.lru_cache(maxsize=None)
def _modulus(q_bits):
    """generate_primes gives q in (2^b, 2^(b+1)); "62" is the largest
    prime below 2^62."""
    if q_bits == 62:
        return jnt.generate_primes(1, 61, False)[0]
    return jnt.generate_primes(1, q_bits, True)[0]


def _u64(rng, hi, size=SIZE):
    """Uniform u64 in [0, hi) (hi up to 2^64), its last entries 0, 1 and
    hi - 1."""
    v = rng.integers(0, hi - 1, size=size, dtype=np.uint64, endpoint=True)
    if size > 3:
        v[-3:] = np.array([0, 1, hi - 1], dtype=np.uint64)
    return v


@pytest.fixture
def approx_on(monkeypatch):
    monkeypatch.setattr(jax_config, "approx_butterflies", lambda: True)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: True)


def _t(v):
    return to_tensor(v, "cpu")


def _eq(got, want, what=""):
    got = to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, from_limbs(want)
                                  if not isinstance(want, np.ndarray)
                                  else want, err_msg=what)


# -- the four limb functions --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_mulhi64_approx_vs_jax(seed):
    rng = np.random.default_rng(seed)
    x, y = _u64(rng, 1 << 64, 4099), _u64(rng, 1 << 64, 4099)
    got = limb.mulhi64_approx(_t(x), _t(y))
    _eq(got, jlimb.mulhi64_approx(to_limbs(x), to_limbs(y)))
    exact = to_numpy(limb.mulhi64(_t(x), _t(y)))
    diff = exact - to_numpy(got)
    assert set(np.unique(diff)) <= {0, 1}
    # A scalar second operand, as the Barrett factors are passed.
    _eq(limb.mulhi64_approx(_t(x), int(y[5])),
        jlimb.mulhi64_approx(to_limbs(x), jlimb.const64(int(y[5]))))


@pytest.mark.parametrize("q_bits", Q_BITS)
def test_limb_approx_forms_vs_jax(q_bits):
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits)
    x, w = _u64(rng, 1 << 64), _u64(rng, q)
    wp = jnt.barrett_factor(int(w[7]), 64, q)
    if q < (1 << 61):
        _eq(limb.shoup_mul_lazy_approx(_t(x), int(w[7]), limb.s64(wp), q),
            jlimb.shoup_mul_lazy_approx(to_limbs(x), jlimb.const64(int(w[7])),
                                        jlimb.const64(wp), q,
                                        jlimb.const64(2 * q)), "shoup")
    q_barr = jnt.barrett_factor(1, 64, q)
    for omf in (1, 2):
        _eq(limb.barrett_reduce_u64_approx(_t(x), q, q_barr, omf),
            jlimb.barrett_reduce_u64_approx(to_limbs(x), q, q_barr, omf),
            f"barrett omf={omf}")
    a, b = _u64(rng, q), _u64(rng, q)
    _eq(limb.mult_mod_barrett_approx(_t(a), _t(b), q),
        jlimb.mult_mod_barrett_approx(to_limbs(a), to_limbs(b), q), "mult")


# -- the five ops and the row forms -------------------------------------------

@pytest.mark.parametrize("q_bits", Q_BITS)
def test_approx_ops_vs_jax_bodies(approx_on, q_bits):
    """ops.mult_mod, fma_mod, reduce_mod, cmp_sub_mod and
    montgomery_form_in (64-bit) against the JAX bodies with `_approx()`
    on, at every IMF/OMF."""
    q = _modulus(q_bits)
    rng = np.random.default_rng(100 + q_bits)
    assert JK._approx() and ops.approx_for(_t(np.zeros(1, np.uint64)))
    for imf in (1, 2, 4):
        a, b = _u64(rng, imf * q), _u64(rng, imf * q)
        _eq(ops.mult_mod(_t(a), _t(b), q, imf),
            JK.mult_mod(to_limbs(a), to_limbs(b), q, imf), f"mult imf={imf}")
    if q < (1 << 61):
        for imf in (1, 2, 4, 8):
            a, c = _u64(rng, imf * q), _u64(rng, imf * q)
            scalar = int(_u64(rng, imf * q, 1)[0])
            w = jnt.reduce_mod(scalar, q, imf)
            wp = jnt.barrett_factor(w, 64, q)
            for addend in (c, None):
                _eq(ops.fma_mod(_t(a), w, wp,
                                None if addend is None else _t(addend), q,
                                imf),
                    JK.fma_mod(to_limbs(a), scalar,
                               None if addend is None else to_limbs(addend),
                               q, imf), f"fma imf={imf} c={addend is None}")
    wide = _u64(rng, 1 << 64)
    for imf, omf in ((q, 1), (q, 2), (2, 1), (4, 1), (4, 2)):
        a = wide if imf == q else _u64(rng, imf * q)
        _eq(ops.reduce_mod(_t(a), q, imf, omf),
            JK.reduce_mod(to_limbs(a), q, imf, omf),
            f"reduce imf={imf} omf={omf}")
    bound, diff = int(_u64(rng, 1 << 64, 1)[0]), int(_u64(rng, q, 1)[0]) | 1
    for cmp in CMPS:
        _eq(ops.cmp_sub_mod(_t(wide), q, cmp, bound, diff),
            JK.cmp_sub_mod(to_limbs(wide), q, cmp, bound, diff), cmp)
    if q % 2:
        a = _u64(rng, q)
        _eq(ops.montgomery_form_in(_t(a), q),
            JK.montgomery_form_in(to_limbs(a), q), "mont_in")


def test_row_forms_vs_jax_bodies(approx_on):
    """ops.mult_mod_rows and reduce_mod_rows with the approximation on:
    each row against the JAX op of its modulus, every IMF/OMF."""
    moduli = [_modulus(b) for b in Q_BITS]
    rng = np.random.default_rng(7)
    for imf in (1, 2, 4):
        a = np.stack([_u64(rng, imf * q) for q in moduli])
        b = np.stack([_u64(rng, imf * q) for q in moduli])
        got = to_numpy(ops.mult_mod_rows(_t(a), _t(b), moduli, imf))
        for r, q in enumerate(moduli):
            _eq(got[r], JK.mult_mod(to_limbs(a[r]), to_limbs(b[r]), q, imf),
                f"mult row {r} imf={imf}")
    wide = np.stack([_u64(rng, 1 << 64) for _ in moduli])
    for omf in (1, 2):
        got = to_numpy(ops.reduce_mod_rows(_t(wide), moduli, omf))
        for r, q in enumerate(moduli):
            _eq(got[r], JK.reduce_mod(to_limbs(wide[r]), q, q, omf),
                f"reduce row {r} omf={omf}")


def test_lazy_outputs_tell_the_forms_apart(approx_on, monkeypatch):
    """With the switch on the lazy outputs differ from the exact forms'
    somewhere (so the checks above hold the approximate ones), and fully
    reduced ones do not (a 20-bit q: its Barrett factor has a high word,
    so the dropped partial product often carries)."""
    q = _modulus(20)
    rng = np.random.default_rng(3)
    wide = _t(_u64(rng, 1 << 64, 1 << 16))
    approx = ops.reduce_mod(wide, q, q, 2)
    full = ops.reduce_mod(wide, q, q, 1)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: False)
    assert not torch.equal(approx, ops.reduce_mod(wide, q, q, 2))
    assert torch.equal(full, ops.reduce_mod(wide, q, q, 1))
    assert torch.equal(approx % q, ops.reduce_mod(wide, q, q, 2) % q)


@pytest.mark.parametrize("q_bits", [49, 60])
def test_public_ops_vs_jax(approx_on, q_bits):
    """The public ops (device="cpu") against hexl_tpu.eltwise's, both
    with the approximation on."""
    q = _modulus(q_bits)
    rng = np.random.default_rng(q_bits)
    a, b, c = (_u64(rng, 4 * q) for _ in range(3))

    def same(port_fn, *args):
        got = getattr(hexl_tpu_torch, port_fn)(*args, device="cpu")
        np.testing.assert_array_equal(
            got, np.asarray(getattr(jax_eltwise, port_fn)(*args)),
            err_msg=port_fn)

    same("eltwise_mult_mod", a, b, q, 4)
    same("eltwise_fma_mod", a, 12345678901, c, q, 4)
    same("eltwise_reduce_mod", _u64(rng, 1 << 64), q, q, 2)
    same("eltwise_cmp_sub_mod", _u64(rng, 1 << 64), q, "nlt", 1 << 63, 7)
    same("eltwise_montgomery_form_in", _u64(rng, q), q)


def test_kernel_names():
    assert ops.kernel_name("mult", 64, True) == "K4.approx"
    assert ops.kernel_name("fma", 64, True) == "K8.fma.approx"
    assert ops.kernel_name("cmp_sub", 64, True) == "K8.cmp.approx"
    assert ops.kernel_name("mont_in", 64, True) == "K8.mont.approx"
    assert ops.kernel_name("reduce", 64) == "K8.reduce"
    assert not ops.approx_for(_t(np.zeros(1, np.uint64)))
    assert not ops.approx_for(_t(np.zeros(1, np.uint64)), 32)
