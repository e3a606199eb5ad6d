"""The key switch below the top level (kms > ds + 1), as a CKKS chain runs
it after each rescale: the decomposition primes are the basis's first ds,
the keys the first ds of the top level's (ds_top, kc, kms, n) key, the
key prime its last modulus. On a mixed 60/40-bit basis (SEAL's CKKS
recipe) at small N, the port's `key_switch` (the plain versions under the
wrappers, and `key_switch_plain`) against the JAX package's and against
the benchmark's plain exact-integer reference (`hebench/reference`), with
the approximate quotients off and on; and K10's plain multiply-accumulate
at ds 20 with 60-bit rows and worst-case operands against the exact sum.
"""

import importlib

import numpy as np
import pytest
import torch

import hexl_tpu_torch.config as port_config
from hebench import reference as ref
from hexl_tpu import config as jax_config
from hexl_tpu.experimental import key_switch as jax_key_switch
from hexl_tpu_torch import key_switch, nt
from hexl_tpu_torch.limb import to_numpy, to_tensor
from ks_cases import worst_case_mac

ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")

N = 64
KC = 2


def ckks_basis(n, middle):
    """SEAL's CKKS shape {60, 40 x middle, 60}: distinct primes = 1 mod 2n,
    the last (the key prime) a 60-bit one."""
    sixty = nt.generate_primes(2, 59, False, ntt_size=n)
    forty = nt.generate_primes(middle, 39, False, ntt_size=n)
    return (sixty[0],) + tuple(forty) + (sixty[1],)


def level_args(ds, kms, seed):
    """A call at level ds of a key over kms moduli: result (kc, ds, n) and
    the target (ds, n) mod the first ds primes; keys[:ds] of the (kms - 1,
    kc, kms, n) key, keys[j, k, m] uniform mod moduli[m]; the first ds
    modswitch factors. Numpy uint64."""
    moduli = ckks_basis(N, kms - 2)
    rng = np.random.default_rng(seed)

    def rows(qs, lead=()):
        return np.stack([rng.integers(0, q, lead + (N,), dtype=np.uint64)
                         for q in qs], axis=len(lead))

    keys = rows(moduli, (kms - 1, KC))
    msf = [pow(moduli[-1], -1, q) for q in moduli[:kms - 1]]
    return (rows(moduli[:ds], (KC,)), rows(moduli[:ds]), N, ds, kms, ds + 1,
            KC, moduli, keys[:ds], msf[:ds])


@pytest.fixture(params=[False, True], ids=["exact", "approx"])
def approx(request, monkeypatch):
    """The approximate quotients forced off or on, on both sides."""
    monkeypatch.setattr(jax_config, "approx_butterflies",
                        lambda: request.param)
    monkeypatch.setattr(port_config, "approx_butterflies",
                        lambda device: request.param)
    return request.param


@pytest.mark.parametrize("ds,kms", [(3, 6), (1, 6)])
def test_key_switch_below_the_top_level(ds, kms, approx):
    args = level_args(ds, kms, seed=ds * 10 + kms + approx)
    result, target, _, _, _, _, _, moduli, keys, msf = args
    before = result.copy()
    got = key_switch(*args, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jax_key_switch(*args)))
    np.testing.assert_array_equal(got, ks.key_switch_plain(*args,
                                                           device="cpu"))
    np.testing.assert_array_equal(result, before)
    want = ref.key_switch(*(to_tensor(x, "cpu") for x in (result, target,
                                                           keys)),
                          msf, ref.Tables(N, moduli))
    np.testing.assert_array_equal(got, to_numpy(want))
    # The flush is the per-row one where the flushed rows (the first ds
    # primes and the key prime) differ in bit length.
    assert ks.flush_approx(ks.WRAPPERS, moduli, ds, approx) == (
        approx and ds > 1)


@pytest.mark.parametrize("kms", [21, 22])
def test_mac_flush_headroom_at_ds_20(kms):
    """ds 20 with 60-bit rows reaches 2^126.3, within a factor of 3.3 of
    the 128-bit wrap (key_switch.cu's bound), and stays exact."""
    ds, n = 20, 8
    moduli = tuple(nt.generate_primes(kms, 59, False, ntt_size=n))
    t, keys, want, largest = worst_case_mac(moduli, ds, kms, n, "cpu")
    assert largest > 1 << 126 and largest * 3 < 1 << 128
    c = ks.constants(moduli, tuple(pow(moduli[-1], -1, q)
                                   for q in moduli[:ds]), ds,
                     torch.device("cpu"))
    for approx in (False, True):
        got = ks.mac_flush_plain(t, keys, c.mac, ds, 2, kms, approx)
        assert torch.equal(got, want)
