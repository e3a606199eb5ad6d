"""The port's NTT (plain versions, CPU) against `hexl_tpu.ntt.NTT` itself.

On the CPU the JAX engine runs its exact Harvey butterflies, so the port
matches it bit for bit, lazy outputs included. For q < 2^30 the JAX engine
routes N >= 1024 to its single-word `ntt32` body, whose lazy outputs differ
in value from the 64-bit walk's (ntt32.py:11-13). The port's `NTT` routes
those transforms the same way (to its own single-word walk), so there too
every output is compared bit for bit, lazy ones included. The JAX
transforms compile once per (IMF, OMF), so this file keeps to the few
sizes the contract names.
"""

import numpy as np
import pytest

from hexl_tpu import nt as jnt
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu_torch import NTT


def _engines(n, q_bits):
    q = jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    return q, NTT(n, q, device="cpu"), JaxNTT(n, q)


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("q_bits", [50, 60])
def test_mod_factor_matrix_vs_jax_engine(n, q_bits):
    q, mine, theirs = _engines(n, q_bits)
    rng = np.random.default_rng(n + q_bits)
    for imf in (1, 2, 4):
        x = rng.integers(0, imf * q, size=(2, n), dtype=np.uint64)
        for omf in (1, 4):
            np.testing.assert_array_equal(
                mine.forward(x, imf, omf), np.asarray(theirs.forward(x, imf,
                                                                     omf)),
                err_msg=f"fwd imf={imf} omf={omf}")
    for imf in (1, 2):
        x = rng.integers(0, imf * q, size=(2, n), dtype=np.uint64)
        for omf in (1, 2):
            np.testing.assert_array_equal(
                mine.inverse(x, imf, omf), np.asarray(theirs.inverse(x, imf,
                                                                     omf)),
                err_msg=f"inv imf={imf} omf={omf}")


@pytest.mark.parametrize("q_bits", [20, 29])
def test_small_modulus_vs_jax_ntt32(q_bits):
    n = 4096
    q, mine, theirs = _engines(n, q_bits)
    assert mine.plan.single_word
    rng = np.random.default_rng(q_bits)
    x = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    y = mine.forward(x, 1, 1)
    np.testing.assert_array_equal(y, np.asarray(theirs.forward(x, 1, 1)))
    x4 = rng.integers(0, 4 * q, size=(2, n), dtype=np.uint64)
    np.testing.assert_array_equal(mine.forward(x4, 4, 4),
                                  np.asarray(theirs.forward(x4, 4, 4)))
    np.testing.assert_array_equal(mine.inverse(y, 1, 1),
                                  np.asarray(theirs.inverse(y, 1, 1)))
    yi = rng.integers(0, 2 * q, size=(2, n), dtype=np.uint64)
    np.testing.assert_array_equal(mine.inverse(yi, 2, 2),
                                  np.asarray(theirs.inverse(yi, 2, 2)))
