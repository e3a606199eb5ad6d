"""The TPU kernel the port's K6 with a shard base replaces,
`hexl_tpu/parallel/dist_ntt.py::DistNTT._pallas_local`, against the port.

As tests/test_dist_ntt.py runs it: `pl.pallas_call` in interpret mode and
`config.use_pallas` forced on, on the 8 virtual CPU devices. The kernel's
butterflies are the lean approximate ones, so its lazy outputs agree with
the port's (exact) mod q and by range; its fully reduced outputs (forward
OMF 1, the inverse, the fused product) are bit-equal.
"""

import functools

import numpy as np

from hexl_tpu import config
from hexl_tpu import nt as jnt
from hexl_tpu.parallel import DistNTT as JaxDistNTT
from hexl_tpu.parallel import make_mesh as jax_make_mesh
from hexl_tpu_torch.parallel import DistNTT, make_mesh


def test_pallas_local_kernel_vs_port(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(config, "use_pallas", lambda: True)
    n = 1 << 13
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    theirs = JaxDistNTT(n, q, jax_make_mesh(4, 1))
    assert theirs._pallas_local_ok
    mine = DistNTT(n, q, make_mesh(4, 1, ["cpu"] * 4))
    rng = np.random.default_rng(6)
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    lazy = mine.forward(x, 1, 4)
    got = np.asarray(theirs.forward(x, 1, 4))
    np.testing.assert_array_equal(got % np.uint64(q), lazy % np.uint64(q))
    assert got.max() < 4 * q
    np.testing.assert_array_equal(np.asarray(theirs.forward(x, 1, 1)),
                                  mine.forward(x, 1, 1))
    y = lazy % np.uint64(q)
    back = mine.inverse(y, 1, 1)
    np.testing.assert_array_equal(np.asarray(theirs.inverse(y, 1, 1)), back)
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(np.asarray(theirs.poly_mult(x, x)),
                                  mine.poly_mult(x, x))
