"""The composites' approximate quotients in the port against the JAX
package's, bit for bit.

Where `config.approx_butterflies()` is on, the JAX package's composites take
the approximate Barrett and Shoup quotients of `hexl_tpu.limb`
(`mulhi64_approx`): `dyadic_multiply` (dyadic.py:46,74) and
`lr_mat_vec_mult` (its `K.mult_mod`), the key switch's per-row flush
`_barrett_reduce_128` (key_switch.py:34-51; its stacked flush stays
exact), the mod-down's +qk/2 Barrett, reductions and fma_mod at IMF 8
(:236-282), and the same steps of the mesh key switch. Held here, with the
switch forced on both sides: the plain versions of K9, K10 and K11 against
the JAX limb functions on inputs where the approximate quotient is one too
small; the public composites against the JAX package's, with the form each
step took; the flush's rule in both of the JAX function's branches.
"""

import ctypes
import functools
import importlib
import inspect
import pathlib
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hexl_tpu_torch.config as port_config
from hexl_tpu import config as jax_config
from hexl_tpu import limb as jlimb
from hexl_tpu import nt as jnt
from hexl_tpu.eltwise import jnp_kernels as JK
from hexl_tpu.experimental import dyadic_multiply as jax_dyadic_multiply
from hexl_tpu.experimental import key_switch as jax_key_switch
from hexl_tpu.experimental import lr_mat_vec_mult as jax_lr_mat_vec_mult
from hexl_tpu.limb import from_limbs, to_limbs
from hexl_tpu.parallel import dist_key_switch as jax_dist_key_switch
from hexl_tpu.parallel import make_mesh as jax_make_mesh
from hexl_tpu_torch import dyadic_multiply, key_switch, lr_mat_vec_mult, nt
from hexl_tpu_torch.limb import mulhi64, mulhi64_approx, to_numpy, to_tensor
from hexl_tpu_torch.ntt import rns
from hexl_tpu_torch.parallel import dist_key_switch, make_mesh

dyadic = importlib.import_module("hexl_tpu_torch.experimental.dyadic")
ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
jks = importlib.import_module("hexl_tpu.experimental.key_switch")


@pytest.fixture
def approx_on(monkeypatch):
    monkeypatch.setattr(jax_config, "approx_butterflies", lambda: True)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: True)


@functools.lru_cache(maxsize=None)
def _basis(n, bits):
    """One prime q = 1 mod 2n of each bit length in `bits` (generate_primes
    gives q in (2^b, 2^(b+1))), distinct."""
    out = []
    for b in bits:
        q = next(q for q in jnt.generate_primes(len(bits) + 1, b, True,
                                                ntt_size=n) if q not in out)
        out.append(q)
    return tuple(out)


def _residues(rng, moduli, shape):
    return np.stack([rng.integers(0, q, size=shape, dtype=np.uint64)
                     for q in moduli])


def _u64(rng, hi, size):
    return rng.integers(0, hi - 1, size=size, dtype=np.uint64, endpoint=True)


def _t(v):
    return to_tensor(v, "cpu")


def _forms(monkeypatch, module, name):
    """The `approx` argument of every call of module.name."""
    seen = []
    fn = getattr(module, name)
    sig = inspect.signature(fn)

    def recording(*args, **kwargs):
        seen.append(sig.bind(*args, **kwargs).arguments.get("approx", False))
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, recording)
    return seen


def _off_by_one(x, y: int):
    """How many of mulhi64_approx(x, y) (x u64 values) fall one below the
    exact high word: the inputs exercise the approximate quotient's
    correction."""
    x = _t(np.asarray(x, dtype=np.uint64))
    y = _t(np.full(tuple(x.shape), y, dtype=np.uint64))
    return int((mulhi64(x, y) != mulhi64_approx(x, y)).sum())


# -- the plain versions against the JAX limb functions -----------------------

@pytest.mark.parametrize("bits", [(29, 50, 61), (40, 40, 59, 35)])
def test_dyadic_plain_vs_jax_limb(bits):
    n = 4096
    moduli = _basis(1024, bits)
    rng = np.random.default_rng(sum(bits))
    x, y = (np.stack([_residues(rng, moduli, (n,)) for _ in range(2)])
            for _ in range(2))
    consts = dyadic.row_constants(moduli, torch.device("cpu"))
    got = to_numpy(dyadic.dyadic_plain(_t(x[None]), _t(y[None]), consts,
                                       True))
    for i, q in enumerate(moduli):
        def mm(a, b):
            return jlimb.mult_mod_barrett_approx(to_limbs(a), to_limbs(b), q)
        x0, x1, y0, y1 = x[0, i], x[1, i], y[0, i], y[1, i]
        want = [mm(x0, y0), JK.add_mod(mm(x0, y1), mm(x1, y0), q),
                mm(x1, y1)]
        for p in range(3):
            np.testing.assert_array_equal(got[p, i], from_limbs(want[p]))
        # The Barrett quotients of x0 y0: some one too small.
        mu, shift = nt.barrett_mult_constants(q)
        c1 = (x0.astype(object) * y0.astype(object)) >> shift
        assert _off_by_one(c1 % (1 << 64), mu) > 0


def _jax_flush(acc_hi, acc_lo, q):
    t = jlimb.U128(to_limbs(acc_hi), to_limbs(acc_lo))
    return from_limbs(jks._barrett_reduce_128(t, q))


@pytest.mark.parametrize("bits", [(29, 50, 61), (50, 50, 50)])
def test_mac_flush_plain_vs_jax_limb(bits, approx_on):
    n, kc = 2048, 2
    moduli = _basis(1024, bits)
    ds = len(moduli) - 1
    rng = np.random.default_rng(len(bits) + sum(bits))
    t = np.stack([_u64(rng, 4 * q, (ds, n)) for q in moduli])
    keys = np.stack([np.stack([_residues(rng, moduli, (n,))
                               for _ in range(kc)]) for _ in range(ds)])
    c = ks.constants(moduli, (1,) * ds, ds, torch.device("cpu"))
    got = to_numpy(ks.mac_flush_plain(_t(t), _t(keys), c.mac, ds, kc, ds + 1,
                                      True))
    errs = 0
    for i, q in enumerate(moduli):
        for k in range(kc):
            acc = sum(t[i, j].astype(object) * keys[j, k, i].astype(object)
                      for j in range(ds)) % (1 << 128)
            hi = np.array([int(v) >> 64 for v in acc], dtype=np.uint64)
            lo = np.array([int(v) & ((1 << 64) - 1) for v in acc],
                          dtype=np.uint64)
            np.testing.assert_array_equal(got[i, k], _jax_flush(hi, lo, q))
            # The quotients of the words' reductions and of the fold
            # (hi mod q) (2^64 mod q): some one too small.
            q_barr = jnt.barrett_factor(1, 64, q)
            mu, shift = nt.barrett_mult_constants(q)
            fold = (hi.astype(object) % q * ((1 << 64) % q)) >> shift
            errs += (_off_by_one(hi, q_barr) + _off_by_one(lo, q_barr)
                     + _off_by_one(fold, mu))
    assert errs > 0


@pytest.mark.parametrize("bits", [(29, 50, 61), (55, 40, 35)])
def test_spread_and_fold_plain_vs_jax_limb(bits, approx_on):
    n, kc = 4096, 2
    moduli = _basis(1024, bits)
    ds = len(moduli) - 1
    qk = moduli[-1]
    msf = tuple(jnt.inverse_mod(qk % q, q) for q in moduli[:ds])
    c = ks.constants(moduli, msf, ds, torch.device("cpu"))
    rng = np.random.default_rng(sum(bits))
    x = _u64(rng, 2 * qk, (kc, n))
    got = to_numpy(ks.spread_plain(_t(x), c, True))
    q_barr = jnt.barrett_factor(1, 64, qk)
    v = jlimb.barrett_reduce_u64_approx(
        jlimb.add64(to_limbs(x), jlimb.const64(qk >> 1)), qk, q_barr, 1)
    for i, q in enumerate(moduli[:ds]):
        r = JK.reduce_mod(v, q, q, 1) if qk > q else v
        fix = q - jnt.barrett_reduce_64(qk >> 1, q, jnt.barrett_factor(1, 64,
                                                                       q))
        np.testing.assert_array_equal(
            got[i], from_limbs(jlimb.add64(r, jlimb.const64(fix))))
    result = np.stack([_residues(rng, moduli[:ds], (n,)) for _ in range(kc)])
    tpp = np.stack([_residues(rng, moduli, (kc, n))[i]
                    for i in range(ds + 1)])
    tntt = np.stack([_u64(rng, 4 * q, (kc, n)) for q in moduli[:ds]])
    got = to_numpy(ks.fold_plain(_t(result), _t(tpp), _t(tntt), c, True))
    for i, q in enumerate(moduli[:ds]):
        t_ith = jlimb.sub64(jlimb.add64(to_limbs(tpp[i]),
                                        jlimb.const64(4 * q)),
                            to_limbs(tntt[i]))
        prod = JK.fma_mod(t_ith, msf[i], None, q, 8)
        want = JK.add_mod(to_limbs(result[:, i]), prod, q)
        np.testing.assert_array_equal(got[:, i], from_limbs(want))
        x8 = from_limbs(t_ith).astype(object) % q
        assert _off_by_one(x8, c.wp[i]) > 0


# -- the public composites against the JAX package ---------------------------

@pytest.mark.parametrize("bits", [(29, 50, 61), (40, 59, 35, 50, 45)])
def test_dyadic_multiply_and_lr_mat_vec_vs_jax(bits, approx_on, monkeypatch):
    n = 1 << 10
    moduli = _basis(n, bits)
    rng = np.random.default_rng(len(bits))
    x, y = (np.stack([_residues(rng, moduli, (n,)) for _ in range(2)])
            for _ in range(2))
    forms = _forms(monkeypatch, dyadic, "dyadic_plain")
    np.testing.assert_array_equal(
        dyadic_multiply(x, y, moduli, device="cpu"),
        np.asarray(jax_dyadic_multiply(x, y, moduli)))
    w = 3
    c1, c2 = (np.stack([np.stack([_residues(rng, moduli, (n,))
                                  for _ in range(2)]) for _ in range(w)])
              for _ in range(2))
    np.testing.assert_array_equal(
        lr_mat_vec_mult(c1, c2, moduli, device="cpu"),
        np.asarray(jax_lr_mat_vec_mult(c1, c2, moduli)))
    assert forms == [True, True]


def _key_switch_args(n, ds, moduli, seed):
    kc, kms = 2, ds + 1
    qk = moduli[-1]
    rng = np.random.default_rng(seed)
    t_target = _residues(rng, moduli[:ds], (n,))
    keys = np.stack([np.stack([_residues(rng, moduli, (n,))
                               for _ in range(kc)]) for _ in range(ds)])
    msf = [jnt.inverse_mod(qk % q, q) for q in moduli[:ds]]
    result = np.stack([_residues(rng, moduli[:ds], (n,)) for _ in range(kc)])
    return (result, t_target, n, ds, kms, kms, kc, moduli, keys, msf)


def _record_steps(monkeypatch):
    """The approx argument of the flush, spread and fold calls."""
    return {name: _forms(monkeypatch, ks, name)
            for name in ("mac_flush_plain", "spread_plain", "fold_plain")}


@pytest.mark.parametrize("n,ds,bits", [
    (1 << 10, 2, (50, 50, 50)),          # the stacked flush: exact
    (1 << 11, 3, (29, 50, 59, 45)),      # the per-row flush: approximate
    (1 << 12, 4, (40, 40, 40, 40, 50)),  # the key prime's bits differ
])
def test_key_switch_vs_jax(n, ds, bits, approx_on, monkeypatch):
    args = _key_switch_args(n, ds, _basis(n, bits), n + ds)
    steps = _record_steps(monkeypatch)
    got = key_switch(*args, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jax_key_switch(*args)))
    mixed = len(set(bits)) > 1
    assert steps == {"mac_flush_plain": [mixed], "spread_plain": [True],
                     "fold_plain": [True]}
    # The plain pipeline takes the same forms and gives the same bits.
    np.testing.assert_array_equal(ks.key_switch_plain(*args, device="cpu"),
                                  got)
    assert steps["mac_flush_plain"] == [mixed, mixed]


def test_key_switch_switch_off_is_exact(monkeypatch):
    n, ds, bits = 1 << 10, 3, (29, 50, 59, 45)
    args = _key_switch_args(n, ds, _basis(n, bits), 7)
    steps = _record_steps(monkeypatch)
    got = key_switch(*args, device="cpu")
    assert steps == {"mac_flush_plain": [False], "spread_plain": [False],
                     "fold_plain": [False]}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(port_config, "approx_butterflies", lambda device: True)
        np.testing.assert_array_equal(key_switch(*args, device="cpu"), got)
    assert steps["mac_flush_plain"] == [False, True]


def test_dist_key_switch_vs_jax(approx_on, monkeypatch):
    n, ds = 1 << 10, 2
    args = _key_switch_args(n, ds, _basis(n, (40, 40, 40)), 12)
    steps = _record_steps(monkeypatch)
    got = dist_key_switch(*args, make_mesh(2, 2, ["cpu"] * 4))
    # The mesh's flush is the JAX package's per-row one: approximate on
    # every row, whatever the bit lengths (four positions, two each).
    assert steps == {"mac_flush_plain": [True] * 4,
                     "spread_plain": [True] * 4, "fold_plain": [True] * 4}
    np.testing.assert_array_equal(
        got, np.asarray(jax_dist_key_switch(*args, jax_make_mesh(2, 2))))
    np.testing.assert_array_equal(got, key_switch(*args, device="cpu"))


def test_flush_rule():
    steps, mesh = ks.PLAIN, SimpleNamespace(row_flush=True)
    same, mixed = (50, 50, 50), (50, 51, 50)
    q = {b: _basis(64, (b,))[0] for b in (50, 51)}
    for bits, on, row_flush, want in ((same, True, False, False),
                                      (mixed, True, False, True),
                                      (same, True, True, True),
                                      (mixed, False, True, False)):
        moduli = tuple(q[b] for b in bits)
        assert ks.flush_approx(mesh if row_flush else steps, moduli, 2,
                               on) is want


@pytest.mark.parametrize("source,entry,args", [
    ("dyadic.cu", "hexl_dyadic", dyadic._ARGS),
    ("key_switch.cu", "hexl_ks_spread", ks._SPREAD_ARGS),
    ("key_switch.cu", "hexl_ks_fold", ks._FOLD_ARGS),
    ("key_switch.cu", "hexl_ks_mac_flush_parts", ks._MAC_PARTS_ARGS),
    ("cross_rns.cu", "hexl_cross_fwd_conv_rns", rns._CONV_ARGS),
])
def test_c_entries_take_the_wrapper_arguments(source, entry, args):
    """Each wrapper's ctypes argument list matches its C entry's, the form
    (`int approx`) before the stream: a pointer where the entry takes a
    pointer or the stream, an integer of the entry's width elsewhere."""
    text = (pathlib.Path(dyadic.__file__).parents[1] / "csrc"
            / source).read_text()
    match = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    params = [p.strip() for p in match.group(1).split(",")]
    assert len(params) == len(args)
    assert params[-2] == "int approx"
    for param, kind in zip(params, args):
        if "*" in param or param.startswith("cudaStream_t"):
            assert kind is ctypes.c_void_p, param
        elif param.startswith("long long"):
            assert kind is ctypes.c_int64, param
        elif param.startswith("u64"):
            assert kind is ctypes.c_uint64, param
        else:
            assert param.startswith("int") and kind is ctypes.c_int, param
