"""The port's ten public element-wise ops at the edges of the kernels'
16-byte bodies, and K10's plain MAC and flush at key component counts
that cover every group size of the kernel, against the JAX package on the
CPU.

On the card the streaming kernels (csrc/eltwise.cu, csrc/key_switch.cu)
move two elements a thread an access and take odd counts, 8-byte-offset
views and empty tensors in the same kernel; here the same public calls run
the plain versions, held bit for bit against `hexl_tpu.eltwise` on the
same seeded inputs: counts that are no multiple of the accesses (1, 3, 5,
1023), empty operands, and torch views (offset, strided, transposed,
offset rows) as operands. `mac_flush_plain` is held against the JAX key
switch's MAC (`limb.mul64_wide`, `limb.add128`) and flush
(`_barrett_reduce_128`, exact and with the approximate quotients) at kc 1
to MAC_GROUP + 1 and at 2 MAC_GROUP + 1 (`MAC_KCS`): each group size, a
full group with one left, two full groups with one left.
"""

import functools
import importlib
import pathlib
import re

import numpy as np
import pytest
import torch

import hexl_tpu.eltwise as jax_eltwise
import hexl_tpu_torch
import hexl_tpu_torch.config as port_config
from hexl_tpu import config as jax_config
from hexl_tpu import nt as jnt
from hexl_tpu.limb import U128, add128, from_limbs, mul64_wide, to_limbs
from hexl_tpu_torch.limb import to_numpy, to_tensor

ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
jks = importlib.import_module("hexl_tpu.experimental.key_switch")

COUNTS = (1, 3, 5, 1023)
Q_BITS = (29, 60)
OPS = ("add", "sub", "mult", "fma", "reduce", "cmp_add", "cmp_sub",
       "mont_in", "mont_out", "mont_mult")
MAC_KCS = tuple(range(1, ks.MAC_GROUP + 2)) + (2 * ks.MAC_GROUP + 1,)


@functools.lru_cache(maxsize=None)
def _modulus(q_bits):
    return jnt.generate_primes(1, q_bits, True)[0]


def _u64(rng, hi, size):
    return rng.integers(0, hi - 1, size=size, dtype=np.uint64, endpoint=True)


def _calls(op, q, rng, size):
    """[(public function name, args)] of `op` under q on fresh inputs of
    `size`: every form the op takes (vector and scalar operands, the IMFs,
    the range changes, the addend or none)."""
    if op in ("add", "sub"):
        a, b = _u64(rng, q, size), _u64(rng, q, size)
        return [(f"eltwise_{op}_mod", (a, b, q)),
                (f"eltwise_{op}_mod", (a, int(_u64(rng, q, None)), q))]
    if op == "mult":
        return [("eltwise_mult_mod", (_u64(rng, imf * q, size),
                                      _u64(rng, imf * q, size), q, imf))
                for imf in (1, 4)]
    if op == "fma":
        a, c = _u64(rng, 8 * q, size), _u64(rng, 8 * q, size)
        w = int(_u64(rng, q, None))
        return [("eltwise_fma_mod", (a, w, c, q, 8)),
                ("eltwise_fma_mod", (a, w, None, q, 8))]
    if op == "reduce":
        return [("eltwise_reduce_mod",
                 (_u64(rng, 1 << 64 if imf == q else imf * q, size), q, imf,
                  omf)) for imf, omf in ((q, 1), (4, 1), (2, 2))]
    if op == "cmp_add":
        return [("eltwise_cmp_add", (_u64(rng, 1 << 64, size), "nlt",
                                     1 << 63, int(_u64(rng, 1 << 64, None))))]
    if op == "cmp_sub":
        return [("eltwise_cmp_sub_mod", (_u64(rng, 1 << 64, size), q, "le",
                                         q // 2, 7))]
    if op == "mont_mult":
        return [("eltwise_montgomery_mult_reduce",
                 (_u64(rng, q, size), _u64(rng, q, size), q))]
    name = "eltwise_montgomery_form_" + op[-3:].lstrip("_")
    return [(name, (_u64(rng, q, size), q))]


def _same(name, args):
    got = getattr(hexl_tpu_torch, name)(*args, device="cpu")
    want = np.asarray(getattr(jax_eltwise, name)(*args))
    assert isinstance(got, np.ndarray) and got.dtype == np.uint64
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("q_bits", Q_BITS)
def test_odd_counts_vs_jax(op, q_bits):
    """Every form of each public op at counts that leave a scalar tail (and
    no body at all at 1), bit for bit."""
    q = _modulus(q_bits)
    rng = np.random.default_rng(OPS.index(op) * 100 + q_bits)
    for size in COUNTS:
        for name, args in _calls(op, q, rng, size):
            _same(name, args)


@pytest.mark.parametrize("op", OPS)
def test_empty_operands(op):
    """An empty operand gives an empty result of the JAX package's shape
    and type, in both words."""
    rng = np.random.default_rng(3)
    for q_bits in Q_BITS:
        for name, args in _calls(op, _modulus(q_bits), rng, 0):
            got = getattr(hexl_tpu_torch, name)(*args, device="cpu")
            assert isinstance(got, np.ndarray) and got.dtype == np.uint64
            assert got.shape == (0,)
            t_args = tuple(to_tensor(a, "cpu") if isinstance(a, np.ndarray)
                           else a for a in args)
            out = getattr(hexl_tpu_torch, name)(*t_args)
            assert isinstance(out, torch.Tensor) and out.shape == (0,)


# Views of a torch tensor as operands: (name, base shape, view); the port
# makes each contiguous (`_device.operands`), an offset view keeps its
# 8-byte offset.
VIEWS = {
    "offset": ((1025,), lambda x: x[1:]),
    "strided": ((2046,), lambda x: x[::2]),
    "transposed": ((31, 33), lambda x: x.t()),
    "offset_rows": ((4, 257), lambda x: x[1:, 1:]),
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_views_vs_jax(view):
    """Each public op on views of torch tensors (int64 of u64 bits) as its
    vector operands, against the JAX op on the same values as numpy."""
    shape, cut = VIEWS[view]
    rng = np.random.default_rng(sorted(VIEWS).index(view))
    for q_bits in Q_BITS:
        q = _modulus(q_bits)
        for op in OPS:
            for name, args in _calls(op, q, rng, shape):
                views = tuple(cut(to_tensor(a, "cpu"))
                              if isinstance(a, np.ndarray) else a
                              for a in args)
                assert all(not isinstance(v, torch.Tensor) or
                           v.storage_offset() or not v.is_contiguous()
                           for v in views)
                values = tuple(to_numpy(v.contiguous())
                               if isinstance(v, torch.Tensor) else v
                               for v in views)
                got = getattr(hexl_tpu_torch, name)(*views)
                assert isinstance(got, torch.Tensor)
                want = np.asarray(getattr(jax_eltwise, name)(*values))
                np.testing.assert_array_equal(to_numpy(got), want)


@functools.lru_cache(maxsize=None)
def _basis(bits):
    out = []
    for b in bits:
        out.append(next(p for p in jnt.generate_primes(4, b, True)
                        if p not in out))
    return tuple(out)


def _jax_mac_flush(t, keys, moduli, ds, kc):
    """(ds + 1, kc, n): the JAX key switch's per-(i, k) MAC over j of
    t[i][j] * keys[j][k][key_idx(i)] in limbs (U128, add128) and its
    Barrett-128 flush (`_barrett_reduce_128`), key_idx(i) = i, or the key
    prime's row (kms - 1 = ds) for i = ds."""
    out = np.empty((ds + 1, kc, t.shape[-1]), dtype=np.uint64)
    for i, q in enumerate(moduli):
        for k in range(kc):
            acc = None
            for j in range(ds):
                prod = mul64_wide(to_limbs(t[i, j]), to_limbs(keys[j, k, i]))
                acc = prod if acc is None else add128(acc, prod)
            out[i, k] = from_limbs(jks._barrett_reduce_128(
                U128(acc.hi, acc.lo), q))
    return out


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("kc", MAC_KCS)
def test_mac_flush_plain_every_kc_vs_jax(kc, approx, monkeypatch):
    """K10's plain version at each kc of MAC_KCS, exact and
    with `_barrett_reduce_128`'s approximate quotients (the switch forced
    on both sides), over rows of mixed bit lengths, an odd n and ds past
    a group of the kernel's four j trips."""
    monkeypatch.setattr(jax_config, "approx_butterflies", lambda: approx)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: approx)
    moduli = _basis((29, 50, 61, 45, 60, 55))
    ds, n = len(moduli) - 1, 257
    rng = np.random.default_rng(kc * 2 + approx)
    t = np.stack([_u64(rng, 4 * q, (ds, n)) for q in moduli])
    keys = np.stack([np.stack([np.stack([_u64(rng, q, n) for q in moduli])
                               for _ in range(kc)]) for _ in range(ds)])
    c = ks.constants(moduli, (1,) * ds, ds, torch.device("cpu"))
    got = ks.mac_flush_plain(to_tensor(t, "cpu"), to_tensor(keys, "cpu"),
                             c.mac, ds, kc, ds + 1, approx)
    np.testing.assert_array_equal(to_numpy(got),
                                  _jax_mac_flush(t, keys, moduli, ds, kc))


def test_mac_group_matches_the_kernel():
    """The wrapper's MAC_GROUP is the kernel's, and the C entry launches a
    group of every smaller size for the components left over."""
    text = (pathlib.Path(ks.__file__).parents[1] / "csrc"
            / "key_switch.cu").read_text()
    assert int(re.search(r"constexpr int MAC_GROUP = (\d+);", text)[1]) \
        == ks.MAC_GROUP
    left = re.findall(r"case (\d+): return launch_mac<A, \1>", text)
    assert tuple(int(v) for v in left) == tuple(range(1, ks.MAC_GROUP))


@pytest.mark.parametrize("entry,args", [("hexl_eltwise", "_ARGS"),
                                        ("hexl_eltwise_rows", "_ROWS_ARGS")])
def test_eltwise_entries_take_the_wrapper_arguments(entry, args):
    """The eltwise C entries' parameters match their wrappers' ctypes
    lists: a pointer where the entry takes a pointer or the stream, an
    integer of the entry's width elsewhere."""
    import ctypes

    from hexl_tpu_torch.eltwise import ops
    text = (pathlib.Path(ops.__file__).parents[1] / "csrc"
            / "eltwise.cu").read_text()
    match = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    params = [p.strip() for p in match.group(1).split(",")]
    kinds = getattr(ops, args)
    assert len(params) == len(kinds)
    for param, kind in zip(params, kinds):
        if "*" in param or param.startswith("cudaStream_t"):
            assert kind is ctypes.c_void_p, param
        elif param.startswith("long long"):
            assert kind is ctypes.c_int64, param
        elif param.startswith("u64"):
            assert kind is ctypes.c_uint64, param
        else:
            assert param.startswith("int") and kind is ctypes.c_int, param


def test_chip_smoke_mirrors_the_eltwise_grid():
    """chip_smoke.py's K4 launch-floor grid uses eltwise.cu's CTA size."""
    import chip_smoke
    text = (pathlib.Path(ks.__file__).parents[1] / "csrc"
            / "eltwise.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", text)[1])
    assert chip_smoke.ELTWISE_THREADS == threads
    assert chip_smoke.eltwise_grid(2 << 12, 8 * 132) == (
        (1 << 12) // threads, threads)
