"""The four-step (matmul) NTT (plain folds, CPU) against JAX.

The port's plan is held against `hexl_tpu.ntt.mxu_ntt`'s (weights as
integers, fold tables bit for bit); its transforms against the NumPy
oracle `hexl_tpu.ref` for OMF 1 and against the JAX `fwd_ntt_mxu`/
`inv_ntt_mxu` bit for bit at every IMF/OMF, on the JAX suite's cases
(tests/test_mxu_ntt.py), lazy outputs included; and the plain folds
against the JAX Pallas fold kernels `_fold_twiddle_pallas`/`_final_pallas`
in interpret mode on the same int32 digit planes. The digit product runs
`torch._int_mm` on int8 planes here as on the card; its planes are held
against the JAX bf16 product's.
"""

import numpy as np
import pytest
import torch

from hexl_tpu import nt, ref
from hexl_tpu.limb import from_limbs, to_limbs
from hexl_tpu.ntt import mxu_ntt as jmxu
from hexl_tpu_torch import NTT
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import (clear_plan_cache, fwd_ntt_mxu, get_mxu_plan,
                                inv_ntt_mxu, mxu_ntt)
from tests.torch_threads import one_torch_thread  # noqa: F401

CASES = [
    (256, 29),
    (1024, 29),
    (1024, 49),
    (1024, 52),   # q in (2^52, 2^53): the object path of _mulmod_scalar
    (1024, 60),
    (4096, 49),
    (4096, 62),
    (16384, 49),
    (16384, 60),
]


def _prime(n, bits):
    return nt.generate_primes(1, bits, True, n)[0]


def _oracle(x, n, q, root, forward):
    rop, irop, _ = ref.root_of_unity_powers(n, q, root)
    if forward:
        return ref.fwd_ntt_radix2(x, q, rop, ref.precon64(rop, q), 1, 1)
    return ref.inv_ntt_radix2(x, q, irop, ref.precon64(irop, q), 1, 1)


def test_mulmod_scalar_53bit_regression():
    """q in (2^52, 2^53) overflowed the uint64 path of the JAX package's
    _mulmod_scalar once; the port carries its repair."""
    q = _prime(1024, 52)
    assert (1 << 52) < q < (1 << 53)
    rng = np.random.default_rng(53)
    a = rng.integers(0, 1 << 63, size=1000, dtype=np.uint64)
    for c in (q - 2, q - 1, (q >> 1) + 1):
        want = ((a.astype(object) * (int(c) % q)) % q).astype(np.uint64)
        np.testing.assert_array_equal(mxu_ntt._mulmod_scalar(a, c, q), want)
        np.testing.assert_array_equal(jmxu._mulmod_scalar(a, c, q), want)


@pytest.mark.parametrize("n,bits", [(256, 29), (1024, 52), (4096, 62)])
def test_plan_equals_jax(n, bits):
    q = _prime(n, bits)
    ours, theirs = mxu_ntt.MxuNttPlan(n, q), jmxu.MxuNttPlan(n, q)
    for name in ("n1", "n2", "dw", "dx_fwd", "dx_inv", "dx_mid", "rho",
                 "rho_precon", "mu", "root"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for name in ("wa", "wb", "wbi", "wai"):
        w = np.asarray(getattr(theirs, name).astype(np.float32))
        np.testing.assert_array_equal(getattr(ours, name).T, w.astype(np.int8))
    for name in ("t_tab", "rho_t_tab", "ti_tab", "rho_ti_tab"):
        for mine, jax_limbs in zip(getattr(ours, name), getattr(theirs, name)):
            np.testing.assert_array_equal(mine, from_limbs(jax_limbs))


@pytest.mark.parametrize("n,bits", CASES)
def test_transforms_bit_equal_to_jax_and_oracle(n, bits):
    """Every IMF/OMF of both directions bit for bit against the JAX MXU
    transforms (lazy outputs are [0, 2q) in both), and OMF 1 against the
    oracle."""
    q = _prime(n, bits)
    plan, jplan = get_mxu_plan(n, q), jmxu.get_mxu_plan(n, q)
    rng = np.random.default_rng(n + bits)
    for forward, imfs, omfs in ((True, (1, 2, 4), (1, 4)),
                                (False, (1, 2), (1, 2))):
        ours = fwd_ntt_mxu if forward else inv_ntt_mxu
        theirs = jmxu.fwd_ntt_mxu if forward else jmxu.inv_ntt_mxu
        for imf in imfs:
            if imf * q >= 1 << 64:
                continue
            x = rng.integers(0, imf * q, size=(2, n), dtype=np.uint64)
            for omf in omfs:
                got = ours(x, plan, imf, omf, device="cpu")
                want = from_limbs(theirs(to_limbs(x), jplan, imf, omf))
                np.testing.assert_array_equal(got, want)
                assert got.max() < (q if omf == 1 else 2 * q)
            if imf == 1:
                np.testing.assert_array_equal(
                    got[0] % np.uint64(q),
                    _oracle(x[0], n, q, plan.root, forward))


def test_folds_bit_equal_to_pallas_interpret():
    """The plain folds on the JAX package's own int32 planes (N = 4096,
    49-bit, batch 4) against its Pallas fold kernels in interpret mode; the
    port's int8 `_int_mm` planes equal the JAX bf16 product's."""
    n = 4096
    q = _prime(n, 49)
    plan, jplan = get_mxu_plan(n, q), jmxu.get_mxu_plan(n, q)
    rng = np.random.default_rng(31)
    batch = 4
    x = rng.integers(0, q, size=(batch, n), dtype=np.uint64)
    n1, n2 = plan.n1, plan.n2
    # Pass 1 of the forward: contract i2 of (i2, batch, i1).
    xt = np.ascontiguousarray(x.reshape(batch, n2, n1).transpose(1, 0, 2))
    jplanes = jmxu._matmul_digits(jmxu._split_digits_lead(to_limbs(xt),
                                                          jplan.dx_fwd),
                                  jplan.wa, jplan.groups_fwd1, n2)
    planes = mxu_ntt.digit_matmul(to_tensor(xt, "cpu"),
                                  torch.from_numpy(plan.wa), plan.dx_fwd)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jplanes))
    tabs = plan.tensors("cpu")
    c = mxu_ntt.fold_twiddle_plain(planes, plan, tabs["t_tab"],
                                   tabs["rho_t_tab"], n2, n1)
    jc = jmxu._fold_twiddle_pallas(jplanes, jplan, jplan.t_tab,
                                   jplan.rho_t_tab, n2, batch, n1)
    np.testing.assert_array_equal(to_numpy(c).reshape(n2, batch, n1),
                                  from_limbs(jc))
    # The final pass on those planes, both OMFs.
    jv = from_limbs(jmxu._final_pallas(jplanes, jplan, n2, batch, n1))
    for omf in (2, 1):
        v = to_numpy(mxu_ntt.fold_final_plain(planes, plan, n2, omf))
        want = np.where(jv >= q, jv - np.uint64(q), jv) if omf == 1 else jv
        np.testing.assert_array_equal(v.reshape(n2, batch, n1), want)


def test_matches_ntt_and_caches():
    """The OMF 1 outputs equal the port's NTT (the same transform for the
    same root); the MXU cache is cleared with the plan cache."""
    n = 1024
    q = _prime(n, 50)
    rng = np.random.default_rng(3)
    x = rng.integers(0, q, size=(3, n), dtype=np.uint64)
    plan = get_mxu_plan(n, q)
    ntt = NTT(n, q, device="cpu")
    np.testing.assert_array_equal(fwd_ntt_mxu(x, plan, device="cpu"),
                                  ntt.forward(x))
    np.testing.assert_array_equal(inv_ntt_mxu(x, plan, device="cpu"),
                                  ntt.inverse(x))
    t = to_tensor(x, "cpu")
    assert isinstance(fwd_ntt_mxu(t, plan), torch.Tensor)
    assert get_mxu_plan(n, q) is plan
    clear_plan_cache()
    assert get_mxu_plan(n, q) is not plan
    with pytest.raises(ValueError, match="input_mod_factor"):
        fwd_ntt_mxu(x, plan, 8, device="cpu")
    with pytest.raises(ValueError, match="output_mod_factor"):
        inv_ntt_mxu(x, plan, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="MXU regime"):
        get_mxu_plan(128, nt.generate_primes(1, 50, True, 128)[0])
