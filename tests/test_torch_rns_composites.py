"""The composites on the stacked RNS transform (plain versions, CPU)
against hexl_tpu.

`rns_poly_mult_mod` (the stacked route, and the per-prime routes: a
repeated prime, k = 1, the rule's per-prime pick) against
`hexl_tpu.poly.rns_poly_mult_mod`; `key_switch` at (2^10, ds 3), (2^15,
ds 2) and with a repeated decomposition prime against
`hexl_tpu.experimental.key_switch`, the caller's `result` unchanged; which
route each call took (the stacked transforms exactly where the JAX
functions take theirs); the row ops of K4.rows and K8.reduce.rows against
the JAX element-wise ops; the route rule of the RNS product. Every output
is fully reduced: the tolerance is exact equality.
"""

import numpy as np
import pytest

from hexl_tpu import nt as jnt
from hexl_tpu.eltwise import eltwise_mult_mod as jax_mult_mod
from hexl_tpu.eltwise import eltwise_reduce_mod as jax_reduce_mod
from hexl_tpu.experimental import key_switch as jax_key_switch
from hexl_tpu.poly import rns_poly_mult_mod as jax_rns_poly_mult_mod
from hexl_tpu_torch import key_switch, poly, rns_poly_mult_mod
from hexl_tpu_torch.eltwise import ops
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import rns
from tests.test_torch_rns_stacked import MIXED, _basis, _residues
from tests.torch_threads import one_torch_thread  # noqa: F401


def _count_stacked(monkeypatch):
    """A counter of the stacked transforms the calls below make."""
    calls = []
    stacked = rns._stacked

    def counting(*args):
        calls.append(args[4])
        return stacked(*args)

    monkeypatch.setattr(rns, "_stacked", counting)
    return calls


@pytest.mark.parametrize("route", ["stacked", "repeated", "single",
                                   "per_prime"])
def test_rns_poly_mult_routes_vs_jax(route, monkeypatch):
    n = 1 << 10 if route in ("stacked", "per_prime") else 64
    moduli = {"stacked": _basis(n, (29, 62, 50)),
              "repeated": _basis(n, (29, 62))[:2] + _basis(n, (29,)),
              "single": _basis(n, (62,)),
              "per_prime": _basis(n, (29, 62, 50))}[route]
    if route == "per_prime":
        monkeypatch.setattr(poly, "rns_route", lambda *args: "per_prime")
    calls = _count_stacked(monkeypatch)
    rng = np.random.default_rng(len(route))
    a = _residues(rng, moduli, (3, n))
    b = _residues(rng, moduli, (1, n))    # broadcast against a's rows
    got = rns_poly_mult_mod(a, b, n, moduli, device="cpu")
    np.testing.assert_array_equal(
        got, np.asarray(jax_rns_poly_mult_mod(a, b, n, moduli)))
    # Two stacked forwards and one stacked inverse, or none.
    assert calls == ([True, True, False] if route == "stacked" else [])


@pytest.mark.parametrize("n,ds,bits", [
    (1 << 10, 3, (49,) * 4),
    (1 << 15, 2, (49,) * 3),
    (64, 2, "repeated"),
])
def test_key_switch_stacked_vs_jax(n, ds, bits, monkeypatch):
    kc, kms = 2, ds + 1
    if bits == "repeated":
        moduli = _basis(n, (45,)) * 2 + _basis(n, (50,))
    else:
        moduli = _basis(n, bits)
    qk = moduli[-1]
    rng = np.random.default_rng(n + ds)
    t_target = _residues(rng, moduli[:ds], (n,))
    keys = np.stack([np.stack([_residues(rng, moduli, (n,))
                               for _ in range(kc)]) for _ in range(ds)])
    msf = [jnt.inverse_mod(qk % q, q) for q in moduli[:ds]]
    result = np.stack([_residues(rng, moduli[:ds], (n,)) for _ in range(kc)])
    before = result.copy()
    calls = _count_stacked(monkeypatch)
    got = key_switch(result, t_target, n, ds, kms, kms, kc, moduli, keys,
                     msf, device="cpu")
    want = np.asarray(jax_key_switch(result, t_target, n, ds, kms, kms, kc,
                                     moduli, keys, msf))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(result, before)
    # The target's inverses, the converted block, the mod-down's forwards:
    # stacked where the decomposition primes are distinct, as in JAX.
    assert calls == ([] if bits == "repeated" else [False, True, True])


@pytest.mark.parametrize("imf", [1, 2, 4])
def test_mult_mod_rows_vs_jax(imf):
    n = 257
    moduli = _basis(1024, MIXED)
    rng = np.random.default_rng(imf)
    a, b = (_residues(rng, moduli, (2, n), imf) for _ in range(2))
    got = to_numpy(ops.mult_mod_rows(to_tensor(a, "cpu"), to_tensor(b, "cpu"),
                                     moduli, imf))
    for i, q in enumerate(moduli):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax_mult_mod(a[i], b[i], q, imf)))


@pytest.mark.parametrize("omf", [1, 2])
def test_reduce_mod_rows_vs_jax(omf):
    moduli = _basis(1024, MIXED)
    rng = np.random.default_rng(omf)
    x = rng.integers(0, 1 << 64, size=(len(moduli), 3, 129), dtype=np.uint64)
    got = to_numpy(ops.reduce_mod_rows(to_tensor(x, "cpu"), moduli, omf))
    for i, q in enumerate(moduli):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax_reduce_mod(x[i], q, q, omf)))


@pytest.mark.parametrize("k", [2, 3, 16])
def test_rns_route_is_a_route(k):
    for log_n in range(1, 21):
        for batch in (1, 2, 8, 100, 4096):
            route = poly.rns_route(1 << log_n, k, batch)
            assert route in poly.RNS_ROUTES
            if log_n > 14:
                assert route == "stacked"
    # The card's crossover: K3 once a prime from batch 256 at 2^13, and at
    # 2^12 up to 4 primes (poly.rns_route's table).
    assert poly.rns_route(1 << 13, k, 256) == "per_prime"
    assert poly.rns_route(1 << 12, k, 256) == ("per_prime" if k <= 4
                                                else "stacked")
    assert poly.rns_route(1 << 14, k, 4096) == "stacked"
