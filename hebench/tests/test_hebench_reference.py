"""The plain reference against independent arithmetic at tiny N: Python
integers, a schoolbook negacyclic product, the transform evaluated point
by point, and the key switch worked out through the CRT."""

from __future__ import annotations

import ast
import pathlib
import random

import pytest
import torch

from hebench import reference as ref
from hebench.reference.ntt import _bitrev, minimal_root
from hebench.tests.conftest import seal_primes

REF_DIR = pathlib.Path(ref.__file__).parent


@pytest.mark.parametrize("bits", [20, 40, 49, 55, 56, 60, 62])
def test_mulmod_is_exact(bits):
    rng = random.Random(bits)
    q = seal_primes(8, [bits])[0]
    a = [rng.randrange(q) for _ in range(500)] + [q - 1, 0, 1]
    b = [rng.randrange(q) for _ in range(500)] + [q - 1, q - 1, 1]
    got = ref.mulmod(torch.tensor(a), torch.tensor(b), torch.tensor(q), bits)
    assert got.tolist() == [x * y % q for x, y in zip(a, b)]


def test_mulmod_f64_is_not():
    q = seal_primes(8, [55])[0]
    g = torch.Generator().manual_seed(1)
    a, b = (torch.randint(0, q, (1000,), generator=g) for _ in range(2))
    bad = ref.mulmod_f64(a, b, torch.tensor(q), 55) != ref.mulmod(
        a, b, torch.tensor(q), 55)
    assert bad.float().mean() > 0.9


def test_minimal_root():
    for q in seal_primes(16, [30, 45]):
        r = minimal_root(32, q)
        assert pow(r, 16, q) == q - 1
        assert r == min(x for x in (pow(r, k, q) for k in range(1, 32, 2)))


def _poly(rng, q, n):
    return [rng.randrange(q) for _ in range(n)]


@pytest.mark.parametrize("n", [2, 8, 32])
def test_forward_is_the_evaluation_at_the_odd_powers(n):
    moduli = seal_primes(n, [30, 50, 55])
    tab = ref.Tables(n, moduli)
    rng = random.Random(n)
    x = [[_poly(rng, q, n) for _ in range(2)] for q in moduli]
    y = ref.forward(torch.tensor(x), tab)
    rev = _bitrev(n)
    for i, q in enumerate(moduli):
        psi = minimal_root(2 * n, q)
        for b in range(2):
            want = [sum(c * pow(psi, (2 * int(rev[j]) + 1) * k, q)
                        for k, c in enumerate(x[i][b])) % q
                    for j in range(n)]
            assert y[i, b].tolist() == want
    assert torch.equal(ref.inverse(y, tab), torch.tensor(x))


def schoolbook(a, b, q):
    """The negacyclic product of a and b mod (x^n + 1, q)."""
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] += a[i] * b[j]
            else:
                out[k - n] -= a[i] * b[j]
    return [c % q for c in out]


@pytest.mark.parametrize("n", [4, 16, 64])
def test_transform_product_is_the_schoolbook_product(n):
    moduli = seal_primes(n, [48, 49, 61])
    tab = ref.Tables(n, moduli)
    rng = random.Random(7 * n)
    a = [_poly(rng, q, n) for q in moduli]
    b = [_poly(rng, q, n) for q in moduli]
    fa, fb = (ref.forward(torch.tensor(v).unsqueeze(1), tab) for v in (a, b))
    prod = ref.mulmod(fa, fb, tab.q.view(-1, 1, 1), tab.bits)
    got = ref.inverse(prod, tab)[:, 0]
    for i, q in enumerate(moduli):
        assert got[i].tolist() == schoolbook(a[i], b[i], q)


def test_dyadic():
    n, moduli = 8, seal_primes(8, [50, 55])
    rng = random.Random(3)
    x = [[_poly(rng, q, n) for q in moduli] for _ in range(2)]
    y = [[_poly(rng, q, n) for q in moduli] for _ in range(2)]
    got = ref.dyadic(torch.tensor(x), torch.tensor(y), torch.tensor(moduli),
                     55)
    for m, q in enumerate(moduli):
        for c in range(n):
            x0, x1 = x[0][m][c], x[1][m][c]
            y0, y1 = y[0][m][c], y[1][m][c]
            assert got[:, m, c].tolist() == [
                x0 * y0 % q, (x0 * y1 + x1 * y0) % q, x1 * y1 % q]


def _intt_direct(v, q, n):
    psi = minimal_root(2 * n, q)
    rev = _bitrev(n)
    n_inv = pow(n, -1, q)
    return [n_inv * sum(v[j] * pow(psi, -(2 * int(rev[j]) + 1) * k, q)
                        for j in range(n)) % q for k in range(n)]


def _ntt_direct(c, q, n):
    psi = minimal_root(2 * n, q)
    rev = _bitrev(n)
    return [sum(x * pow(psi, (2 * int(rev[j]) + 1) * k, q)
                for k, x in enumerate(c)) % q for j in range(n)]


def _crt(residues, moduli):
    big = 1
    for q in moduli:
        big *= q
    x = 0
    for r, q in zip(residues, moduli):
        m = big // q
        x += r * m * pow(m, -1, q)
    return x % big, big


@pytest.mark.parametrize("ds,kc", [(1, 1), (3, 2)])
def test_key_switch_is_the_rounded_division_by_the_key_prime(ds, kc):
    """With P_k = sum_j c_j * K_jk (schoolbook negacyclic products of
    integers; c_j the target's residue mod q_j, K_jk the key lifted
    through the CRT over every prime), the switch adds floor((P_k +
    (qk - 1)/2) / qk) mod q_i to result: SEAL's mod-down."""
    n = 8
    moduli = seal_primes(n, [40] * ds + [41])
    qk, half = moduli[-1], moduli[-1] >> 1
    rng = random.Random(ds * 10 + kc)
    result = [[_poly(rng, q, n) for q in moduli[:ds]] for _ in range(kc)]
    target = [_poly(rng, q, n) for q in moduli[:ds]]
    keys = [[[_poly(rng, q, n) for q in moduli] for _ in range(kc)]
            for _ in range(ds)]
    msf = [pow(qk, -1, q) for q in moduli[:ds]]
    got = ref.key_switch(torch.tensor(result), torch.tensor(target),
                         torch.tensor(keys), msf, ref.Tables(n, moduli))
    coeffs = [_intt_direct(target[j], moduli[j], n) for j in range(ds)]
    for k in range(kc):
        p = [0] * n
        for j in range(ds):
            key_coeffs = [_intt_direct(keys[j][k][m], q, n)
                          for m, q in enumerate(moduli)]
            lifted = [_crt([key_coeffs[m][c] for m in range(len(moduli))],
                           moduli)[0] for c in range(n)]
            prod = schoolbook(coeffs[j], lifted, 1 << 400)
            p = [a + (b if b < (1 << 399) else b - (1 << 400))
                 for a, b in zip(p, prod)]
        big = _crt([0] * len(moduli), moduli)[1]
        d = [((x % big) + half) // qk for x in p]
        for i, q in enumerate(moduli[:ds]):
            want = [(r + t) % q for r, t in
                    zip(result[k][i], _ntt_direct([v % q for v in d], q, n))]
            assert got[k, i].tolist() == want


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in REF_DIR.glob("*.py"):
        assert _imports(path) <= {"__future__", "numpy", "torch"}, path
