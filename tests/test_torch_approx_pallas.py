"""The port's "approx" scheme against the JAX package's approximate-quotient
butterflies, bit for bit, lazy outputs included.

The JAX Pallas kernels run `_fwd_butterfly_approx`/`_inv_butterfly_approx`
(`pallas_ntt._butterflies`) for every q < 2^61 unless
HEXL_TPU_DISABLE_APPROX is set, in interpret mode on the CPU too. The port
runs the same pair as the scheme "approx" of its plain walks and kernels.
Held here: the plain butterflies against the JAX ones (random inputs and
the edges of their ranges); the port's kernel wrappers with
scheme="approx" (their plain versions on the CPU) against
`pallas_ntt._run` and `_packed_stage_kernel`, `hier.fwd_ntt_hier`/
`inv_ntt_hier` at 2^15, `poly._poly_mult_pallas` and
`DistNTT._pallas_local`, each in interpret mode with the kill switch
unset; the port's PipelineNTT against the JAX one with the approximation
forced on both sides; and the scheme's modulus bound.
"""

import functools

import numpy as np
import pytest
import torch

import hexl_tpu_torch.config as port_config
from hexl_tpu import config as jax_config
from hexl_tpu import nt as jnt
from hexl_tpu.limb import const64, from_limbs, to_limbs
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu.ntt import jnp_ntt
from hexl_tpu_torch import get_plan
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import cuda_ntt, torch_ntt
from tests.torch_threads import one_torch_thread  # noqa: F401

# The largest prime below 2^61 that is 1 mod 2N, and smaller moduli.
Q_BITS = (29, 50, 60, 61)


def _prime(q_bits, n):
    if q_bits == 61:
        return jnt.generate_primes(1, 60, False, ntt_size=n)[0]
    return jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]


@pytest.fixture
def approx_pallas(monkeypatch):
    """The Pallas kernels in interpret mode with their default (approx)
    butterflies: the kill switch unset."""
    from jax.experimental import pallas as pl
    monkeypatch.delenv("HEXL_TPU_DISABLE_APPROX", raising=False)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _jax_pair(fn, xs, ys, w, wp, q):
    nx, ny = fn(to_limbs(xs), to_limbs(ys), to_limbs(w), to_limbs(wp),
                const64(q), const64(2 * q))
    return from_limbs(nx), from_limbs(ny)


def _port_pair(fn, xs, ys, w, wp, q):
    t = lambda v: to_tensor(v, "cpu")
    nx, ny = fn(t(xs), t(ys), t(w), t(wp), q, "approx")
    return to_numpy(nx), to_numpy(ny)


@pytest.mark.parametrize("q_bits", Q_BITS)
def test_butterflies_vs_jax(q_bits):
    """The plain "approx" butterflies against `_fwd_butterfly_approx` and
    `_inv_butterfly_approx` on random inputs of their ranges ([0, 4q)
    forward, [0, 2q) inverse) and on their edges (0, q - 1, 2q - 1,
    4q - 1, twiddles 0, 1 and q - 1)."""
    q = _prime(q_bits, 16)
    rng = np.random.default_rng(q_bits)
    count = 4096
    w = rng.integers(0, q, size=count, dtype=np.uint64)
    edges = np.array([0, 1, q - 1, 2 * q - 1, 4 * q - 1, 3 * q, 2 * q],
                     dtype=np.uint64)
    w[:3] = np.array([0, 1, q - 1], dtype=np.uint64)
    wp = np.array([jnt.barrett_factor(int(v), 64, q) for v in w],
                  dtype=np.uint64)
    for fn, top, name in ((jnp_ntt._fwd_butterfly_approx, 4 * q,
                           "fwd_butterfly"),
                          (jnp_ntt._inv_butterfly_approx, 2 * q,
                           "inv_butterfly")):
        xs = rng.integers(0, top, size=count, dtype=np.uint64)
        ys = rng.integers(0, top, size=count, dtype=np.uint64)
        ok = edges[edges < top]
        xs[:len(ok) ** 2] = np.repeat(ok, len(ok))
        ys[:len(ok) ** 2] = np.tile(ok, len(ok))
        want = _jax_pair(fn, xs, ys, w, wp, q)
        got = _port_pair(getattr(torch_ntt, name), xs, ys, w, wp, q)
        for g, e, leg in zip(got, want, "xy"):
            np.testing.assert_array_equal(g, e, err_msg=f"{name} {leg}")
            assert g.max() < top


def test_shoup_approx_any_input_vs_jax():
    """The approximate Shoup product takes any 64-bit input, as the
    `_shoup_approx` of the JAX kernels does: [0, 2q) from inputs up to
    2^64 - 1, q just below 2^61."""
    q = _prime(61, 16)
    rng = np.random.default_rng(61)
    x = rng.integers(0, 1 << 64, size=4096, dtype=np.uint64)
    x[:2] = np.array([0, (1 << 64) - 1], dtype=np.uint64)
    w = rng.integers(0, q, size=4096, dtype=np.uint64)
    wp = np.array([jnt.barrett_factor(int(v), 64, q) for v in w],
                  dtype=np.uint64)
    want = from_limbs(jnp_ntt._shoup_approx(
        to_limbs(x), to_limbs(w), to_limbs(wp), const64(q), const64(2 * q)))
    t = lambda v: to_tensor(v, "cpu")
    got = to_numpy(torch_ntt.shoup_approx_harvey(t(x), t(w), t(wp), q))
    np.testing.assert_array_equal(got, want)
    assert got.max() < 2 * q


@pytest.mark.parametrize("n,batch", [(1 << 10, 8), (1 << 11, 1)])
def test_ntt_vs_pallas_kernels(approx_pallas, n, batch):
    """`pallas_ntt.fwd_ntt`/`inv_ntt` (`_packed_stage_kernel` at (2^10, 8),
    `_run` at (2^11, 1)) at every OMF, bit for bit with the port in
    "approx", lazy outputs included. Neither side's code depends on the
    IMF (a contract on the input), so each OMF runs once on inputs of the
    widest IMF range, [0, 4q) forward and [0, 2q) inverse, which hold the
    narrower ones."""
    from hexl_tpu.ntt import pallas_ntt
    q = _prime(50, n)
    jp, plan = jax_get_plan(n, q), get_plan(n, q)
    rng = np.random.default_rng(n + batch)
    for forward, imf, omfs in ((True, 4, (1, 4)), (False, 2, (1, 2))):
        jfn = pallas_ntt.fwd_ntt if forward else pallas_ntt.inv_ntt
        pfn = cuda_ntt.fwd_ntt if forward else cuda_ntt.inv_ntt
        x = rng.integers(0, imf * q, size=(batch, n), dtype=np.uint64)
        x[0, :4] = np.array([0, q - 1, q, imf * q - 1], dtype=np.uint64)
        for omf in omfs:
            theirs = from_limbs(jfn(to_limbs(x), jp, imf, omf))
            mine = to_numpy(pfn(to_tensor(x, "cpu"), plan, imf, omf, 64,
                                "approx"))
            np.testing.assert_array_equal(
                mine, theirs, err_msg=f"fwd={forward} omf={omf}")
            assert mine.max() < omf * q


def test_lazy_differs_from_exact(approx_pallas):
    """The scheme changes lazy values (so the comparison above tells the
    schemes apart) and no fully reduced one."""
    n = 1 << 11
    q = _prime(60, n)
    plan = get_plan(n, q)
    x = to_tensor(np.random.default_rng(5).integers(
        0, q, size=(4, n), dtype=np.uint64), "cpu")
    lazy = {s: cuda_ntt.fwd_ntt(x, plan, 1, 4, 64, s)
            for s in ("exact", "approx")}
    assert not torch.equal(lazy["exact"], lazy["approx"])
    assert torch.equal(lazy["exact"] % q, lazy["approx"] % q)
    assert torch.equal(cuda_ntt.fwd_ntt(x, plan, 1, 1, 64, "approx"),
                       cuda_ntt.fwd_ntt(x, plan, 1, 1))


def test_hier_vs_pallas_kernels(approx_pallas, one_torch_thread):
    """hier.py::_cross_call and ::_local_call at 2^15 (D = 2) with their
    approx butterflies, against the port's split in "approx" (K5/K6's
    plain versions): the lazy forward (OMF 4) and inverse (OMF 2), of which
    OMF 1 is the reduction."""
    from hexl_tpu.ntt import hier as jax_hier
    n = 1 << 15
    q = _prime(60, n)
    plan, jp = get_plan(n, q), jax_get_plan(n, q)
    rng = np.random.default_rng(15)
    x = rng.integers(0, 4 * q, size=(1, n), dtype=np.uint64)
    theirs = from_limbs(jax_hier.fwd_ntt_hier(to_limbs(x), jp, 4, 4))
    mine = cuda_ntt.fwd_ntt(to_tensor(x, "cpu"), plan, 4, 4, 64, "approx")
    np.testing.assert_array_equal(to_numpy(mine), theirs)
    y = rng.integers(0, 2 * q, size=(1, n), dtype=np.uint64)
    theirs = from_limbs(jax_hier.inv_ntt_hier(to_limbs(y), jp, 2, 2))
    mine = cuda_ntt.inv_ntt(to_tensor(y, "cpu"), plan, 2, 2, 64, "approx")
    np.testing.assert_array_equal(to_numpy(mine), theirs)


def test_poly_mult_vs_pallas_kernel(approx_pallas):
    """`poly._poly_mult_pallas` (approx butterflies) against K3's route in
    "approx" and the plain approx chain."""
    from hexl_tpu import poly as jax_poly
    from hexl_tpu_torch import poly
    n = 1 << 10
    q = _prime(60, n)
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, q, size=(2, n), dtype=np.uint64)
            for _ in range(2))
    theirs = from_limbs(jax_poly._poly_mult_pallas(
        to_limbs(a), to_limbs(b), jax_get_plan(n, q)))
    plan = get_plan(n, q)
    ta, tb = to_tensor(a, "cpu"), to_tensor(b, "cpu")
    np.testing.assert_array_equal(
        to_numpy(poly.poly_mult(ta, tb, plan, "approx")), theirs)
    np.testing.assert_array_equal(
        to_numpy(poly.poly_mult_plain(ta, tb, plan, "approx")), theirs)


def test_dist_pallas_local_vs_port(monkeypatch):
    """`DistNTT._pallas_local` (approx butterflies; the cross pass exact)
    against the port's DistNTT with local_scheme="approx", bit for bit,
    the lazy forward included (the harness of test_torch_dist_pallas)."""
    from jax.experimental import pallas as pl

    from hexl_tpu.parallel import DistNTT as JaxDistNTT
    from hexl_tpu.parallel import make_mesh as jax_make_mesh
    from hexl_tpu_torch.parallel import DistNTT, make_mesh
    monkeypatch.delenv("HEXL_TPU_DISABLE_APPROX", raising=False)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jax_config, "use_pallas", lambda: True)
    n = 1 << 13
    q = _prime(60, n)
    theirs = JaxDistNTT(n, q, jax_make_mesh(4, 1))
    assert theirs._pallas_local_ok
    mine = DistNTT(n, q, make_mesh(4, 1, ["cpu"] * 4), local_scheme="approx")
    rng = np.random.default_rng(13)
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    lazy = mine.forward(x, 1, 4)
    np.testing.assert_array_equal(np.asarray(theirs.forward(x, 1, 4)), lazy)
    exact = DistNTT(n, q, make_mesh(4, 1, ["cpu"] * 4)).forward(x, 1, 4)
    assert not np.array_equal(exact, lazy)
    y = rng.integers(0, 2 * q, size=n, dtype=np.uint64)
    np.testing.assert_array_equal(np.asarray(theirs.inverse(y, 2, 2)),
                                  mine.inverse(y, 2, 2))


def test_pipeline_vs_jax_forced(monkeypatch):
    """The JAX PipelineNTT with `config.approx_butterflies` forced takes
    `jnp_ntt._bflys`'s approx pair; the port's with its switch forced
    takes "approx" (K16's plain version): bit for bit, lazy outputs
    included."""
    from hexl_tpu.parallel import PipelineNTT as JaxPipelineNTT
    from hexl_tpu.parallel import make_pipeline_mesh as jax_ring
    from hexl_tpu_torch.parallel import PipelineNTT, make_pipeline_mesh
    from hexl_tpu_torch.parallel import pipeline
    monkeypatch.setattr(jax_config, "approx_butterflies", lambda: True)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: True)
    n = 1 << 12
    q = _prime(60, n)
    assert pipeline.pipeline_scheme(q, "cpu") == "approx"
    mine = PipelineNTT(n, q, make_pipeline_mesh(4, ["cpu"] * 4))
    theirs = JaxPipelineNTT(n, q, jax_ring(4))
    rng = np.random.default_rng(12)
    x = rng.integers(0, 4 * q, size=(3, n), dtype=np.uint64)
    y = mine.forward(x, 4, 4)
    np.testing.assert_array_equal(y, np.asarray(theirs.forward(x, 4, 4)))
    z = rng.integers(0, 2 * q, size=(3, n), dtype=np.uint64)
    np.testing.assert_array_equal(mine.inverse(z, 2, 2),
                                  np.asarray(theirs.inverse(z, 2, 2)))


def test_pipeline_scheme_bound(monkeypatch):
    """PipelineNTT's stages stay exact for q >= 2^61 and with the switch
    off, as `jnp_ntt._bflys` does."""
    from hexl_tpu_torch.parallel import pipeline
    assert pipeline.pipeline_scheme(_prime(50, 16), "cpu") == "exact"
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: True)
    assert pipeline.pipeline_scheme(_prime(61, 16), "cpu") == "approx"
    assert pipeline.pipeline_scheme((1 << 61) + 1, "cpu") == "exact"


@pytest.mark.parametrize("q", [(1 << 61) + 1, (1 << 62) - 57])
def test_approx_refuses_q_of_61_bits(q):
    """The raw product lies in [0, 8q): check_scheme refuses q >= 2^61, as
    JAX's lean_ok gate does; the stacked transform and the single word
    refuse the scheme."""
    with pytest.raises(ValueError, match="2\\^61"):
        torch_ntt.check_scheme("approx", q)
    torch_ntt.check_scheme("approx", (1 << 61) - 1)
    with pytest.raises(ValueError, match="single-word"):
        torch_ntt.check_scheme("approx", 97, 32)


def test_stacked_and_local_refuse_other_schemes():
    from hexl_tpu_torch.ntt import get_rns_plan, rns, shard
    n = 1 << 6
    moduli = [_prime(b, n) for b in (49, 50)]
    rplan = get_rns_plan(n, moduli)
    x = torch.zeros((2, 1, n), dtype=torch.int64)
    with pytest.raises(ValueError, match="stacked"):
        rns.fwd_ntt_rns(x, rplan, 1, 1, "approx")
    x = torch.zeros((1, 64), dtype=torch.int64)
    plan = get_plan(n, moduli[0])
    with pytest.raises(ValueError, match="local pass"):
        shard.local(x, plan, 0, 1, True, 1, "lean8")
