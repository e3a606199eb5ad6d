"""The port's g++-built host library (`hexl_tpu_torch.native`) against its
pure-Python `nt` and plan tables, and against the JAX package's
`hexl_tpu.native`; HEXL_TPU_DISABLE_NATIVE takes the Python path."""

import numpy as np
import pytest

from hexl_tpu import native as jax_native
from hexl_tpu_torch import _build, config, native, nt
from hexl_tpu_torch.ntt import plan as plan_mod

PRIME_CANDIDATES = [2, 3, 4, 97, 1024, 281474976710897, 0xFFFFFFFFFFC0001,
                    (1 << 61) - 1, (1 << 61) - 2, 4194353, (1 << 62) - 57,
                    (1 << 64) - 59, (1 << 64) - 1]


@pytest.fixture
def python_only(monkeypatch):
    monkeypatch.setenv("HEXL_TPU_DISABLE_NATIVE", "1")
    assert not native.available()


def test_library_is_built_from_the_port_source():
    assert native.available()
    lib = _build.build_host()
    assert lib.name == "libhost.so" and lib.parent == _build.build_dir()
    assert lib.parent.parent == _build.BUILD_ROOT


def test_is_prime_parity(python_only, monkeypatch):
    python = [nt.is_prime(v) for v in PRIME_CANDIDATES]
    monkeypatch.delenv("HEXL_TPU_DISABLE_NATIVE")
    assert [native.is_prime(v) for v in PRIME_CANDIDATES] == python
    assert [nt.is_prime(v) for v in PRIME_CANDIDATES] == python
    if jax_native.available():
        assert [jax_native.is_prime(v) for v in PRIME_CANDIDATES] == python


@pytest.mark.parametrize("bits,small,ntt_size", [
    (45, True, 4096), (50, False, 1 << 14), (29, True, 1 << 17),
    (61, False, 1 << 17), (20, True, 2)])
def test_generate_primes_parity(python_only, monkeypatch, bits, small,
                                ntt_size):
    python = nt.generate_primes(5, bits, small, ntt_size)
    monkeypatch.delenv("HEXL_TPU_DISABLE_NATIVE")
    got = native.generate_primes(5, bits, small, ntt_size)
    assert got == python == nt.generate_primes(5, bits, small, ntt_size)
    assert got == (sorted(got) if small else sorted(got, reverse=True))
    if jax_native.available():
        assert jax_native.generate_primes(5, bits, small, ntt_size) == got


def test_generate_primes_out_of_reach():
    """What the library cannot answer falls to the Python scan, as in the
    JAX package: 63 bits and more, and a range holding too few primes."""
    assert native.generate_primes(1, 63, True, 2) is None
    assert native.generate_primes(10 ** 6, 10, True, 2) is None
    with pytest.raises(RuntimeError, match="failed to find"):
        nt.generate_primes(10 ** 6, 10, True, 2)


@pytest.mark.parametrize("degree,modulus", [
    (4, 0xFFFFFFFFFFC0001), (16, 4194353), (128, 769),
    (1 << 18, None)])
def test_minimal_root_parity(python_only, monkeypatch, degree, modulus):
    if modulus is None:
        modulus = nt.generate_primes(1, 61, True, ntt_size=degree // 2)[0]
    python = nt.minimal_primitive_root(degree, modulus)
    monkeypatch.delenv("HEXL_TPU_DISABLE_NATIVE")
    got = native.minimal_primitive_root(degree, modulus)
    assert got == python == nt.minimal_primitive_root(degree, modulus)
    if degree == 4:
        assert got == 288794978602139552
    if jax_native.available():
        assert jax_native.minimal_primitive_root(degree, modulus) == got


Q_CASES = {
    "29-bit": lambda: nt.generate_primes(1, 29, True, ntt_size=1 << 17)[0],
    "50-bit": lambda: nt.generate_primes(1, 50, True, ntt_size=1 << 17)[0],
    "60-bit": lambda: nt.generate_primes(1, 60, True, ntt_size=1 << 17)[0],
    "largest 62-bit": lambda: nt.generate_primes(1, 61, False,
                                                 ntt_size=1 << 17)[0],
}


@pytest.mark.parametrize("q_name", list(Q_CASES))
def test_root_tables_equal_the_python_tables(q_name):
    """At every N from 2^1 to 2^17: the native tables bit-equal to the
    Python ones (the plan's plain versions) and to the JAX library's."""
    q = Q_CASES[q_name]()
    for log_n in range(1, 18):
        n = 1 << log_n
        root = nt.minimal_primitive_root(2 * n, q)
        rop, irop, prop, pirop = native.root_tables(n, q, root)
        py_rop, py_irop = plan_mod.root_of_unity_powers(n, q, root)
        np.testing.assert_array_equal(rop, py_rop)
        np.testing.assert_array_equal(irop, py_irop)
        np.testing.assert_array_equal(prop, plan_mod.precon(py_rop, q, 64))
        np.testing.assert_array_equal(pirop, plan_mod.precon(py_irop, q, 64))
        if jax_native.available() and log_n in (1, 10, 17):
            for mine, theirs in zip((rop, irop, prop, pirop),
                                    jax_native.root_tables(n, q, root)):
                np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("log_n,q_bits", [(1, 50), (10, 29), (12, 60),
                                          (15, 29), (16, 61)])
def test_disable_native_takes_python_path_and_gives_equal_plans(
        monkeypatch, log_n, q_bits):
    n = 1 << log_n
    q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
    built = plan_mod.NttPlan.build(n, q)
    original, calls = plan_mod.root_of_unity_powers, []

    def counted(*args):
        calls.append(args)
        return original(*args)

    monkeypatch.setattr(plan_mod, "root_of_unity_powers", counted)
    monkeypatch.setenv("HEXL_TPU_DISABLE_NATIVE", "1")
    assert config.native_disabled() and native.root_tables(n, q, 3) is None
    python = plan_mod.NttPlan.build(n, q)
    assert calls, "the Python tables were not computed"
    names = ["rop", "prop", "irop", "pirop"] + (
        ["prop32", "pirop32"] if built.bit_shift == 32 else [])
    for name in names:
        np.testing.assert_array_equal(getattr(python, name),
                                      getattr(built, name))
    assert python.root == built.root
    assert python.fin(64) == built.fin(64)


def test_failed_host_build_raises(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_host()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_nt_helpers_match_jax():
    """maximum_value, add_uint_mod, sub_uint_mod and multiply_mod_lazy with
    the JAX package's semantics and errors (tests/test_nt.py:88-96)."""
    from hexl_tpu import nt as jax_nt
    for bits in (0, 1, 31, 32, 63, 64):
        assert nt.maximum_value(bits) == jax_nt.maximum_value(bits)
    for mod in (nt, jax_nt):
        with pytest.raises(ValueError, match="bits must be <= 64"):
            mod.maximum_value(65)
    q = 0xFFFFFFFFFFC0001
    for x in (0, 1, q - 1, 2 * q - 1, 123456789):
        for y in (1, 2, q - 1, 888888):
            assert nt.add_uint_mod(x, y, q) == jax_nt.add_uint_mod(x, y, q)
            assert nt.sub_uint_mod(x, y, q) == jax_nt.sub_uint_mod(x, y, q)
            for shift in (32, 64):
                yb = nt.barrett_factor(y, shift, q)
                r = nt.multiply_mod_lazy(x, y, yb, q, shift)
                assert r == jax_nt.multiply_mod_lazy(x, y, yb, q, shift)
                if shift == 64:
                    assert r < 2 * q and r % q == (x * y) % q
