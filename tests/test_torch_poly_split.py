"""K3's cluster decomposition of the negacyclic product, modelled with the
port's plain pieces, bit for bit.

In the cluster form (hexl_tpu_torch/csrc/poly.cu) CTA r of a pair runs the
forward of one operand to [0, 4q), then takes half r of the positions:
it multiplies the two forward outputs there at IMF 4, runs the inverse
stages of stride < N/2 on that half as shard r of two (the local pass of
`hier.local_launch_plain` with log_d = 1), and the two CTAs share the
final stage (stride N/2, fused with N^-1, OMF 1). Put together from
`torch_ntt.fwd_ntt`, `torch_kernels.mult_mod`, `hier.local_launch_plain`
and `torch_ntt.inv_final`, that chain must be the product itself: it is
held against the port's plain chain (`poly_mult_plain`), the JAX package's
`poly_mult_mod` (N <= 2^10) and a product of Python integers by Kronecker
substitution (up to 2^14). No tolerance: every comparison is bit-equal.
"""

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu.poly import poly_mult_mod as jax_poly_mult_mod
from hexl_tpu_torch import get_plan, poly
from hexl_tpu_torch.eltwise import torch_kernels
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import hier, torch_ntt
from tests.torch_threads import one_torch_thread  # noqa: F401


def split_product(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """The cluster form's chain on the plain pieces."""
    fa = torch_ntt.fwd_ntt(a, plan, 1, 4)
    fb = torch_ntt.fwd_ntt(b, plan, 1, 4)
    half = plan.n // 2
    halves = []
    for r in (0, 1):
        at = slice(r * half, (r + 1) * half)
        prod = torch_kernels.mult_mod(fa[..., at], fb[..., at], plan.q, 4)
        halves.append(hier.local_launch_plain(
            prod, plan, False, 1, plan.log_n - 1, 1, r, 0))
    return torch_ntt.inv_final(torch.cat(halves, dim=-1), plan, 1)


def kronecker_product(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """a*b mod (X^N + 1, q) for two uint64 vectors in Python integers: each
    operand packed into one integer, a coefficient a slot of 17 bytes (more
    than 2 log2 q + log2 N bits, so no slot overflows), the two integers
    multiplied, the slots of the product unpacked and folded."""
    n, width = a.size, 17

    def pack(v):
        slots = np.zeros((n, width), dtype=np.uint8)
        slots[:, :8] = v.astype("<u8").view(np.uint8).reshape(n, 8)
        return int.from_bytes(slots.tobytes(), "little")

    raw = (pack(a) * pack(b)).to_bytes(2 * n * width, "little")
    full = [int.from_bytes(raw[i * width:(i + 1) * width], "little")
            for i in range(2 * n)]
    return np.array([(full[i] - full[n + i]) % q for i in range(n)],
                    dtype=np.uint64)


def _operands(log_n: int, q_bits: int, batch: int = 2):
    n = 1 << log_n
    q = jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    rng = np.random.default_rng(1000 + log_n)
    a, b = (rng.integers(0, q, size=(batch, n), dtype=np.uint64)
            for _ in range(2))
    return a, b, q, get_plan(n, q)


@pytest.mark.parametrize("log_n", range(1, 15))
def test_split_product_is_the_plain_product(log_n):
    a, b, _, plan = _operands(log_n, 60)
    ta, tb = to_tensor(a, "cpu"), to_tensor(b, "cpu")
    assert torch.equal(split_product(ta, tb, plan),
                       poly.poly_mult_plain(ta, tb, plan))


@pytest.mark.parametrize("log_n", [1, 4, 7, 10])
def test_split_product_vs_jax(log_n):
    a, b, q, plan = _operands(log_n, 50)
    got = split_product(to_tensor(a, "cpu"), to_tensor(b, "cpu"), plan)
    np.testing.assert_array_equal(
        to_numpy(got), np.asarray(jax_poly_mult_mod(a, b, 1 << log_n, q)))


@pytest.mark.parametrize("log_n,q_bits", [(3, 61), (9, 60), (12, 50),
                                          (14, 60)])
def test_split_product_vs_python_integers(log_n, q_bits):
    a, b, q, plan = _operands(log_n, q_bits, batch=1)
    got = to_numpy(split_product(to_tensor(a, "cpu"), to_tensor(b, "cpu"),
                                 plan))
    np.testing.assert_array_equal(got[0], kronecker_product(a[0], b[0], q))


def test_kronecker_product_is_the_schoolbook_product():
    """The Python-integer reference against the O(N^2) schoolbook sum."""
    n, q = 32, jnt.generate_primes(1, 61, True, ntt_size=32)[0]
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, q, size=n, dtype=np.uint64) for _ in range(2))
    school = [0] * n
    for i in range(n):
        for j in range(n):
            k, s = (i + j, 1) if i + j < n else (i + j - n, -1)
            school[k] += s * int(a[i]) * int(b[j])
    assert [int(v) for v in kronecker_product(a, b, q)] == [
        v % q for v in school]


def test_forms_and_their_degrees(monkeypatch):
    """The wrapper's forms: the cluster from 2^12 to 2^14, the one-CTA
    form up to 2^13; the occupancy query refuses a degree the cluster does
    not take, and on the CPU every form is the plain chain. `form_for`
    picks the cluster at 2^14, and at 2^12-2^13 while its two CTAs a pair
    fit the SMs one each; else the one-CTA form."""
    assert [poly.forms_of(1 << k) for k in (1, 11, 12, 13, 14)] == [
        ["cta"], ["cta"], ["cluster", "cta"], ["cluster", "cta"],
        ["cluster"]]
    a, b, _, plan = _operands(8, 50)
    ta, tb = to_tensor(a, "cpu"), to_tensor(b, "cpu")
    want = poly.poly_mult_plain(ta, tb, plan)
    for form in poly.FORMS:
        monkeypatch.setattr(poly, "form_for", lambda *args, f=form: f)
        assert torch.equal(poly.poly_mult(ta, tb, plan), want)
    monkeypatch.undo()
    for degree in (1 << 11, 1 << 15):
        with pytest.raises(ValueError):
            poly.max_active_clusters(degree, "cpu")
    for log_n in range(1, 15):
        for batch in (1, 2, 64, 66, 67, 132, 4096):
            form = poly.form_for(1 << log_n, batch, 132)
            assert form in poly.forms_of(1 << log_n)
            assert form == ("cluster" if log_n == 14 or (
                log_n >= 12 and batch <= 66) else "cta")
