"""The two-pass split of N > 2^14 (plain versions, CPU) against JAX.

The split (cross pass then local pass; local then cross for the inverse) is
held bit for bit, lazy outputs included, against the port's flat walk and
the NumPy oracle `hexl_tpu.ref` at N = 2^15, 2^17 and 2^20, for q just
above 2^50, 2^60 and 2^61 and for the largest q below 2^62, where 4q is
just under 2^64 (the edge of the lazy ranges); against the
JAX engine `hexl_tpu.ntt.NTT` (its exact staged body on the CPU) at 2^15;
and against the JAX split itself, `hier.fwd_ntt_hier`/`inv_ntt_hier`, with
its Pallas kernels in interpret mode at 2^15. Those kernels would use the
lean approximate butterflies for q < 2^61 (pallas_ntt.py:53-61); the test
sets HEXL_TPU_DISABLE_APPROX=1 so that they run the exact ones, and
compares every output bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.limb import from_limbs, to_limbs
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu_torch import NTT, get_plan, plan_from_arrays
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import cuda_ntt, hier, torch_ntt
from tests.torch_threads import one_torch_thread  # noqa: F401


def _prime(q_bits, n):
    """The smallest prime above 2^q_bits that is 1 mod 2N; for q_bits = 62
    the largest one below 2^62 instead."""
    if q_bits == 62:
        return jnt.generate_primes(1, 61, False, ntt_size=n)[0]
    return jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]


def _blocks(x, plan):
    """x (..., N) as the cross pass's (..., N/2^14, 2^14) block."""
    return x.reshape(*x.shape[:-1], hier.shards(plan), hier.LOCAL_N)


def _split_fwd(x, plan, omf):
    c = hier.cross_fwd_plain(_blocks(x, plan), plan).reshape(x.shape)
    return hier.local_fwd_plain(c, plan, omf)


def _split_inv(x, plan, omf):
    loc = _blocks(hier.local_inv_plain(x, plan), plan)
    return hier.cross_inv_plain(loc, plan, omf).reshape(x.shape)


def _check(n, q, batch, fwd_factors, inv_factors, seed):
    """For each (IMF, OMFs) of a direction: one input, the split at every
    OMF, the flat walk and the oracle at the lazy OMF (the last). OMF 1 is
    the lazy output reduced mod q, so it is held against the oracle's lazy
    output mod q."""
    plan, jp = get_plan(n, q), jax_get_plan(n, q)
    rng = np.random.default_rng(seed)
    cases = ((True, fwd_factors, _split_fwd, torch_ntt.fwd_ntt,
              lambda v, imf, omf: ref.fwd_ntt_radix2(v, q, jp.rop, jp.prop,
                                                     imf, omf)),
             (False, inv_factors, _split_inv, torch_ntt.inv_ntt,
              lambda v, imf, omf: ref.inv_ntt_radix2(v, q, jp.irop, jp.pirop,
                                                     imf, omf)))
    for forward, factors, split, flat, oracle in cases:
        for imf, omfs in factors:
            lazy = omfs[-1]
            x = rng.integers(0, imf * q, size=(batch, n), dtype=np.uint64)
            xt = to_tensor(x, "cpu")
            want = np.stack([oracle(v, imf, lazy) for v in x])
            got = {omf: split(xt, plan, omf) for omf in omfs}
            assert torch.equal(got[lazy], flat(xt, plan, imf, lazy))
            for omf in omfs:
                expect = want if omf == lazy else want % np.uint64(q)
                np.testing.assert_array_equal(
                    to_numpy(got[omf]), expect,
                    err_msg=f"forward={forward} imf={imf} omf={omf}")


# (IMF, OMFs) of the forward and of the inverse: the full matrix.
FWD_MATRIX = [(imf, (1, 4)) for imf in (1, 2, 4)]
INV_MATRIX = [(imf, (1, 2)) for imf in (1, 2)]
FWD_PAIRS = [(imf, omf) for imf, omfs in FWD_MATRIX for omf in omfs]
INV_PAIRS = [(imf, omf) for imf, omfs in INV_MATRIX for omf in omfs]


@pytest.mark.parametrize("log_n", [15, 17])
@pytest.mark.parametrize("q_bits", [50, 60, 61, 62])
def test_split_equals_flat_walk_and_oracle(log_n, q_bits):
    """The full IMF/OMF matrix; batch 2 at 2^15, batch 1 at 2^17."""
    n = 1 << log_n
    _check(n, _prime(q_bits, n), 2 if log_n == 15 else 1, FWD_MATRIX,
           INV_MATRIX, log_n + q_bits)


@pytest.mark.parametrize("q_bits", [60, 61, 62])
def test_split_at_max_degree(q_bits):
    """N = 2^20 (D = 64 shards), batch 1, OMF 1 and the lazy OMF."""
    n = 1 << 20
    _check(n, _prime(q_bits, n), 1, [(1, (1, 4))], [(1, (1, 2))], q_bits)


def test_public_engine_vs_jax_engine():
    """`NTT` at 2^15 (the two-pass split) against the JAX engine, whose
    staged body runs the exact butterflies on the CPU: the port over the
    full IMF/OMF matrix, bit for bit. The JAX bodies read the IMF only as
    the input's range, so the JAX engine is called at the widest IMF of
    its direction (one compile per OMF)."""
    n = 1 << 15
    q = _prime(60, n)
    mine, theirs = NTT(n, q, device="cpu"), JaxNTT(n, q)
    rng = np.random.default_rng(15)
    for imf, omf in FWD_PAIRS:
        x = rng.integers(0, imf * q, size=(2, n), dtype=np.uint64)
        np.testing.assert_array_equal(
            mine.forward(x, imf, omf), np.asarray(theirs.forward(x, 4, omf)),
            err_msg=f"fwd {imf} {omf}")
    for imf, omf in INV_PAIRS:
        x = rng.integers(0, imf * q, size=(2, n), dtype=np.uint64)
        np.testing.assert_array_equal(
            mine.inverse(x, imf, omf), np.asarray(theirs.inverse(x, 2, omf)),
            err_msg=f"inv {imf} {omf}")


@pytest.fixture
def exact_interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setenv("HEXL_TPU_DISABLE_APPROX", "1")
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def test_split_vs_jax_hier_kernels(exact_interpret_pallas):
    """hier.py::_cross_call and ::_local_call (D = 2) in interpret mode with
    exact butterflies, against the port's split: bit for bit (the forward
    at both OMFs, the inverse at the lazy OMF 2, which OMF 1 only
    reduces)."""
    from hexl_tpu.ntt import hier as jax_hier
    n = 1 << 15
    q = _prime(50, n)
    plan, jp = get_plan(n, q), jax_get_plan(n, q)
    rng = np.random.default_rng(2)
    x = rng.integers(0, q, size=(1, n), dtype=np.uint64)
    for omf in (1, 4):
        theirs = from_limbs(jax_hier.fwd_ntt_hier(to_limbs(x), jp, 1, omf))
        mine = cuda_ntt.fwd_ntt(to_tensor(x, "cpu"), plan, 1, omf)
        np.testing.assert_array_equal(to_numpy(mine), theirs,
                                      err_msg=f"fwd omf {omf}")
    y = rng.integers(0, 2 * q, size=(1, n), dtype=np.uint64)
    theirs = from_limbs(jax_hier.inv_ntt_hier(to_limbs(y), jp, 2, 2))
    mine = cuda_ntt.inv_ntt(to_tensor(y, "cpu"), plan, 2, 2)
    np.testing.assert_array_equal(to_numpy(mine), theirs)


@pytest.mark.parametrize("log_n,q_bits", [(17, 60), (14, 29)])
def test_plan_from_jax_tables(log_n, q_bits):
    """A plan carried over from the JAX plan's rop/prop/irop/pirop gives
    the outputs of the port's own plan, in either regime; the single-word
    constants derived from the carried tables equal the JAX plan's."""
    n = 1 << log_n
    q = _prime(q_bits, n)
    jp = jax_get_plan(n, q)
    carried = plan_from_arrays(n, q, jp.root, jp.rop, jp.prop, jp.irop,
                               jp.pirop)
    own = get_plan(n, q)
    assert carried.single_word == own.single_word == (q_bits < 30)
    if carried.single_word:
        assert carried.inv_n_precon32 == jp.inv_n_precon32
        assert carried.inv_n_w_precon32 == jp.inv_n_w_precon32
    engines = [NTT(n, q, device="cpu") for _ in range(2)]
    engines[0].plan = carried
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, 4 * q, size=(2, n), dtype=np.uint64)
    for omf in (1, 4):
        np.testing.assert_array_equal(engines[0].forward(x, 4, omf),
                                      engines[1].forward(x, 4, omf))
    y = x % np.uint64(2 * q)
    for omf in (1, 2):
        np.testing.assert_array_equal(engines[0].inverse(y, 2, omf),
                                      engines[1].inverse(y, 2, omf))


def test_split_errors():
    n = 1 << 14
    plan = get_plan(n, _prime(50, n))
    with pytest.raises(ValueError, match="2\\^14"):
        hier.fwd_ntt(torch.zeros(n, dtype=torch.int64), plan)
    with pytest.raises(ValueError, match="2\\^14"):
        hier.local(torch.zeros(n, dtype=torch.int64), plan, True)
