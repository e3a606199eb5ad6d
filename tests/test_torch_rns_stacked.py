"""The port's stacked RNS transform (plain versions, CPU) against hexl_tpu.

`fwd_ntt_rns`/`inv_ntt_rns` and `RnsNTT` against `hexl_tpu.ntt.rns` at
N = 16, 2^10 and 2^13 over a basis of 29- to 62-bit primes (the largest
prime below 2^62 among them), inputs shaped (k, N), (k, b, N) and
(k, b1, b2, N), every IMF/OMF pair; at N = 2^15 and 2^17 against the NumPy
oracle `hexl_tpu.ref`, row by row; the plain stacked walk against each
row's `torch_ntt` walk in every scheme `scheme_for` can pick; the
descriptors, their cache and their layout. The composites that take the
stacked route are held in test_torch_rns_composites.py. Lazy outputs
included, every comparison is exact equality.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.ntt import RnsNTT as JaxRnsNTT
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu_torch import RnsNTT, config
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import clear_plan_cache, get_plan, rns, torch_ntt
from tests.torch_threads import one_torch_thread  # noqa: F401

RNS_CUH = (pathlib.Path(__file__).resolve().parents[1] / "hexl_tpu_torch"
           / "csrc" / "rns.cuh")


def _basis(n, bits):
    """Distinct primes = 1 mod 2n; "62" is the largest prime below 2^62."""
    out = []
    for b in bits:
        ps = (jnt.generate_primes(4, 61, False, ntt_size=n) if b == 62
              else jnt.generate_primes(4, b, True, ntt_size=n))
        out.append(next(q for q in ps if q not in out))
    return out


def _residues(rng, moduli, shape, factor=1):
    return np.stack([rng.integers(0, factor * q, size=shape,
                                  dtype=np.uint64) for q in moduli])


MIXED = (29, 62, 50, 60)
PAIRS = ([(True, imf, omf) for imf in (1, 2, 4) for omf in (1, 4)]
         + [(False, imf, omf) for imf in (1, 2) for omf in (1, 2)])
SHAPES = ((), (2,), (2, 3))


@pytest.mark.parametrize("n", [16, 1 << 10, 1 << 13])
@pytest.mark.parametrize("case", range(len(PAIRS)))
def test_stacked_vs_jax(n, case):
    """Each IMF/OMF pair in one of the three input shapes (they take turns
    over the pairs, so every shape meets both directions)."""
    forward, imf, omf = PAIRS[case]
    moduli = _basis(n, MIXED)
    rng = np.random.default_rng(case + n)
    x = _residues(rng, moduli, SHAPES[case % 3] + (n,), imf)
    theirs = JaxRnsNTT(n, moduli)
    ours = RnsNTT(n, moduli, device="cpu")
    if forward:
        want = np.asarray(theirs.forward(x, imf, omf))
        got = ours.forward(x, imf, omf)
        tensor = rns.fwd_ntt_rns(to_tensor(x, "cpu"), ours.plan, imf, omf)
    else:
        want = np.asarray(theirs.inverse(x, imf, omf))
        got = ours.inverse(x, imf, omf)
        tensor = rns.inv_ntt_rns(to_tensor(x, "cpu"), ours.plan, imf, omf)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(to_numpy(tensor), want)


@pytest.mark.parametrize("log_n", [15, 17])
@pytest.mark.parametrize("forward,imf,omf", [(True, 4, 1), (True, 2, 4),
                                             (False, 2, 1), (False, 1, 2)])
def test_stacked_large_vs_oracle(log_n, forward, imf, omf):
    """Above 2^14 (the split's sizes) against `hexl_tpu.ref`, row by
    row."""
    n = 1 << log_n
    moduli = _basis(n, (29, 62, 50))
    rng = np.random.default_rng(log_n + imf + 3 * omf)
    x = _residues(rng, moduli, (2, n) if log_n == 15 else (n,), imf)
    ours = RnsNTT(n, moduli, device="cpu")
    got = (ours.forward if forward else ours.inverse)(x, imf, omf)
    for i, q in enumerate(moduli):
        jp = jax_get_plan(n, q)
        if forward:
            want = ref.fwd_ntt_radix2(x[i], q, jp.rop, jp.prop, imf, omf)
        else:
            want = ref.inv_ntt_radix2(x[i], q, jp.irop, jp.pirop, imf, omf)
        np.testing.assert_array_equal(got[i], want, err_msg=f"row {i}")


@pytest.mark.parametrize("scheme,log_n", [
    ("exact", 6), ("exact", 10), ("exact", 15), ("lean8", 6), ("lean8", 10),
    ("lean8", 15), ("lean16", 13), ("lean16", 15)])
def test_plain_stacked_walk_is_each_rows_walk(scheme, log_n, monkeypatch):
    """The plain stacked walk row by row against `torch_ntt` under the
    scheme `scheme_for` picks for the basis (forced on, as on a card that
    takes the approximate butterflies)."""
    n = 1 << log_n
    bits = {"exact": (62, 29), "lean16": (59, 29), "lean8": (60, 29)}[scheme]
    moduli = _basis(n, bits)
    monkeypatch.setattr(config, "approx_butterflies", lambda device: True)
    assert torch_ntt.scheme_for(max(moduli), n, "cpu") == scheme
    rplan = rns.get_rns_plan(n, moduli, "cpu")
    rng = np.random.default_rng(log_n)
    x = to_tensor(_residues(rng, moduli, (2, n), 4), "cpu")
    y = to_tensor(_residues(rng, moduli, (2, n), 2), "cpu")
    fwd = rns.fwd_ntt_rns_plain(x, rplan, 4, 4, scheme)
    inv = rns.inv_ntt_rns_plain(y, rplan, 2, 2, scheme)
    for i, q in enumerate(moduli):
        plan = get_plan(n, q)
        assert torch.equal(fwd[i], torch_ntt.fwd_ntt(x[i], plan, 4, 4, 64,
                                                     scheme))
        assert torch.equal(inv[i], torch_ntt.inv_ntt(y[i], plan, 2, 2, 64,
                                                     scheme))
    ours = RnsNTT(n, moduli, device="cpu")
    assert torch.equal(ours.forward(x, 4, 4), fwd)


def test_descriptors_built_at_construction_and_cleared():
    n = 64
    moduli = _basis(n, MIXED)
    clear_plan_cache()
    assert not rns._RNS_PLANS
    ours = RnsNTT(n, moduli, device="cpu")
    plan = ours.plan
    assert plan is rns.get_rns_plan(n, moduli)
    assert "cpu" in plan._rows
    rows = to_numpy(plan._rows["cpu"]).astype(object)
    assert rows.shape == (len(moduli), rns.ROW_WORDS)
    assert rows.tolist() == plan.row_words("cpu")
    for row, p in zip(rows, plan.plans):
        tabs = p._dev["cpu"]
        assert list(row[:5]) == [p.q, *p.fin(64)]
        assert list(row[5:]) == [tabs[t].data_ptr() for t in rns.TABLES]
    clear_plan_cache()
    assert not rns._RNS_PLANS
    fresh = rns.get_rns_plan(n, moduli)
    assert fresh is not plan
    assert all(a is not b for a, b in zip(fresh.plans, plan.plans))


def test_descriptor_layout_matches_the_kernels():
    text = RNS_CUH.read_text()
    body = text[text.index("struct RnsRow {"):text.index("};")]
    fields = re.findall(r"(\w+)(?=[,;])", body)
    assert tuple(fields) == rns.ROW_FIELDS
    words = int(re.search(r"RNS_ROW_WORDS = (\d+);", text).group(1))
    assert words == rns.ROW_WORDS


def test_stacked_errors(monkeypatch):
    n = 64
    moduli = _basis(n, (40, 50))
    with pytest.raises(ValueError, match="moduli must be distinct"):
        rns.get_rns_plan(n, [moduli[0]] * 2)
    rplan = rns.get_rns_plan(n, moduli)
    x = torch.zeros((3, n), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"shape \(2, \.\.\., 64\)"):
        rns.fwd_ntt_rns(x, rplan)
    with pytest.raises(ValueError, match="output_mod_factor"):
        rns.inv_ntt_rns(x[:2], rplan, 1, 4)
    monkeypatch.setattr(config, "debug_checks", lambda: True)
    bad = np.zeros((2, n), dtype=np.uint64)
    bad[1, 3] = moduli[1]
    with pytest.raises(ValueError, match=r"forward RNS NTT input \(prime 1\)"):
        RnsNTT(n, moduli, device="cpu").forward(bad)
