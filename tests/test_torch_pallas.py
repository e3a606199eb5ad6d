"""The port against the Pallas TPU kernels it replaces, in interpret mode.

The Pallas kernels run on the CPU as the JAX package's own tests run them
(`pl.pallas_call` with interpret=True). For q < 2^61 they use the lean
approximate butterflies even there (pallas_ntt.py:53-61), so fully reduced
outputs (OMF=1) are compared bit for bit and lazy outputs mod q and by
range. Covered: pallas_ntt.py::_run (N=2^11, batch 1), the packed route
_packed_stage_kernel (N=2^10, batch 8) and poly.py::_poly_mult_pallas.
"""

import functools

import numpy as np
import pytest

from hexl_tpu import nt as jnt
from hexl_tpu.limb import from_limbs, to_limbs
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu_torch import NTT, poly_mult_mod


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("n,batch", [(1 << 10, 8), (1 << 11, 1)])
def test_ntt_vs_pallas_kernels(interpret_pallas, n, batch):
    from hexl_tpu.ntt import pallas_ntt
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    qq = np.uint64(q)
    jp = jax_get_plan(n, q)
    mine = NTT(n, q, device="cpu")
    rng = np.random.default_rng(n + batch)
    x = rng.integers(0, q, size=(batch, n), dtype=np.uint64)

    def pallas(fn, v, imf, omf):
        return from_limbs(fn(to_limbs(v), jp, imf, omf))

    y = mine.forward(x, 1, 1)
    np.testing.assert_array_equal(y, pallas(pallas_ntt.fwd_ntt, x, 1, 1))
    lazy = mine.forward(x, 1, 4)
    theirs = pallas(pallas_ntt.fwd_ntt, x, 1, 4)
    np.testing.assert_array_equal(lazy % qq, theirs % qq)
    assert lazy.max() < 4 * q and theirs.max() < 4 * q

    np.testing.assert_array_equal(mine.inverse(y, 1, 1),
                                  pallas(pallas_ntt.inv_ntt, y, 1, 1))
    yi = rng.integers(0, 2 * q, size=(batch, n), dtype=np.uint64)
    lazy = mine.inverse(yi, 2, 2)
    theirs = pallas(pallas_ntt.inv_ntt, yi, 2, 2)
    np.testing.assert_array_equal(lazy % qq, theirs % qq)
    assert lazy.max() < 2 * q and theirs.max() < 2 * q


def test_poly_mult_vs_pallas_kernel(interpret_pallas):
    from hexl_tpu import poly
    n = 1 << 10
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, q, size=(2, n), dtype=np.uint64)
            for _ in range(2))
    theirs = from_limbs(poly._poly_mult_pallas(to_limbs(a), to_limbs(b),
                                               jax_get_plan(n, q)))
    np.testing.assert_array_equal(poly_mult_mod(a, b, n, q, device="cpu"),
                                  theirs)
