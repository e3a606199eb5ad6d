"""The port's PipelineNTT on rings of "cpu" positions against the JAX
package's on its 8 virtual CPU devices, bit for bit: both run exact
Harvey butterflies there (the JAX stage bodies pick the lean approximate
ones only on the TPU). The stage partition, D in {2, 8}, the round trip
and the lazy outputs, one microbatch, and the too-few-stages error.
"""

import numpy as np
import pytest

from hexl_tpu import nt as jnt
from hexl_tpu.parallel import PipelineNTT as JaxPipelineNTT
from hexl_tpu.parallel import make_pipeline_mesh as jax_make_pipeline_mesh
from hexl_tpu.parallel.pipeline import _partition as jax_partition
from hexl_tpu_torch.parallel import PipelineNTT, make_pipeline_mesh
from hexl_tpu_torch.parallel.pipeline import _partition


def cpu_ring(d):
    return make_pipeline_mesh(d, ["cpu"] * d)


@pytest.mark.parametrize("k,d", [(12, 8), (17, 8), (10, 3), (5, 5)])
def test_partition_equals_jax(k, d):
    assert _partition(k, d) == jax_partition(k, d)


@pytest.mark.parametrize("d", [2, 8])
def test_forward_vs_jax(d):
    n = 1 << 12
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    mine = PipelineNTT(n, q, cpu_ring(d))
    theirs = JaxPipelineNTT(n, q, jax_make_pipeline_mesh(d))
    rng = np.random.default_rng(d)
    x = rng.integers(0, q, size=(5, 2, n), dtype=np.uint64)
    want = np.asarray(theirs.forward(x, 1, 1))
    np.testing.assert_array_equal(mine.forward(x, 1, 1), want)
    x4 = rng.integers(0, 4 * q, size=(5, 2, n), dtype=np.uint64)
    np.testing.assert_array_equal(mine.forward(x4, 4, 1),
                                  np.asarray(theirs.forward(x4, 4, 1)))


def test_round_trip_and_lazy_vs_jax():
    n = 1 << 12
    q = jnt.generate_primes(1, 60, True, ntt_size=n)[0]
    mine = PipelineNTT(n, q, cpu_ring(8))
    theirs = JaxPipelineNTT(n, q, jax_make_pipeline_mesh(8))
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=(3, n), dtype=np.uint64)
    y = mine.forward(x, 1, 4)
    np.testing.assert_array_equal(y, np.asarray(theirs.forward(x, 1, 4)))
    assert y.max() < 4 * q
    z = y % np.uint64(q)
    np.testing.assert_array_equal(mine.inverse(z, 1, 1), x)
    np.testing.assert_array_equal(mine.inverse(z, 1, 1),
                                  np.asarray(theirs.inverse(z, 1, 1)))
    z2 = y % np.uint64(2 * q)
    np.testing.assert_array_equal(mine.inverse(z2, 2, 2),
                                  np.asarray(theirs.inverse(z2, 2, 2)))


def test_single_microbatch_vs_jax():
    n = 1 << 11
    q = jnt.generate_primes(1, 50, True, ntt_size=n)[0]
    rng = np.random.default_rng(7)
    x = rng.integers(0, q, size=(1, n), dtype=np.uint64)
    np.testing.assert_array_equal(
        PipelineNTT(n, q, cpu_ring(8)).forward(x, 1, 1),
        np.asarray(JaxPipelineNTT(n, q, jax_make_pipeline_mesh(8)).forward(
            x, 1, 1)))


def test_errors_as_jax():
    q = jnt.generate_primes(1, 50, True, ntt_size=64)[0]
    for make in (lambda: JaxPipelineNTT(64, q, jax_make_pipeline_mesh(8)),
                 lambda: PipelineNTT(64, q, cpu_ring(8))):
        with pytest.raises(ValueError, match="fewer stages"):
            make()
    pipe = PipelineNTT(64, q, cpu_ring(4))
    x = np.zeros((2, 64), dtype=np.uint64)
    with pytest.raises(ValueError, match="output_mod_factor"):
        pipe.forward(x, 1, 2)
    with pytest.raises(ValueError, match="input_mod_factor"):
        pipe.inverse(x, 4, 1)
    with pytest.raises(ValueError, match="microbatch"):
        pipe.forward(np.zeros(64, dtype=np.uint64))
