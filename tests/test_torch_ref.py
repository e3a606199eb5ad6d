"""The port's NumPy oracle `hexl_tpu_torch.ref` against `hexl_tpu.ref`.

Every one of its 23 functions, bit for bit, at the shapes of
tests/test_ref_ntt.py (degrees 2 to 2^11, q of 27 to 61 bits, the
IMF/OMF matrix, inputs in the lazy ranges) and tests/test_ref_eltwise.py
(vectors of 5 to 1000 elements, every predicate and mod factor): one case
per function and shape, the same seeded inputs through both modules.
"""

import numpy as np
import pytest

from hexl_tpu import nt as jax_nt
from hexl_tpu import ref as jax_ref
from hexl_tpu_torch import ref

# (log_n, q_bits) of tests/test_ref_ntt.py's random and radix-4 cases.
NTT_SHAPES = [(1, 27), (2, 30), (3, 48), (4, 50), (5, 58), (6, 60), (7, 30),
              (9, 60), (11, 48)]
ELT_SIZES = [5, 300, 1000]
ELT_Q_BITS = [20, 30, 50, 60, 61]


def _prime(bits, n=1):
    return jax_nt.generate_primes(1, bits, True, ntt_size=n)[0]


def _ntt_case(mod, name, log_n, q_bits):
    """The outputs of `mod.name` at one degree over the IMF/OMF matrix."""
    n = 1 << log_n
    q = _prime(q_bits, n)
    rng = np.random.default_rng(log_n * 100 + q_bits)
    rop, irop, root = mod.root_of_unity_powers(n, q)
    if name == "root_of_unity_powers":
        given = mod.root_of_unity_powers(n, q, root)
        return [rop, irop, np.uint64(root), *given[:2], np.uint64(given[2])]
    prop, pirop = mod.precon64(rop, q), mod.precon64(irop, q)
    if name == "precon64":
        return [prop, pirop]
    x = rng.integers(0, q, size=(3, n), dtype=np.uint64)
    lazy = x + np.uint64(q) * rng.integers(0, 4, size=(3, n), dtype=np.uint64)
    if name == "reference_fwd_ntt":
        return [mod.reference_fwd_ntt(x, q, rop)]
    if name == "reference_inv_ntt":
        return [mod.reference_inv_ntt(x, q, irop)]
    fn = getattr(mod, name)
    if name.startswith("fwd"):
        return [fn(lazy % np.uint64(imf * q), q, rop, prop, imf, omf)
                for imf in (1, 2, 4) for omf in (1, 4)]
    return [fn(lazy % np.uint64(imf * q), q, irop, pirop, imf, omf)
            for imf in (1, 2) for omf in (1, 2)]


def _eltwise_case(mod, name, size):
    """The outputs of `mod.name` on vectors of `size` elements, over q of
    every width in ELT_Q_BITS and the function's factors/predicates."""
    rng = np.random.default_rng(size)
    outs = []
    for q_bits in ELT_Q_BITS:
        q = _prime(q_bits)
        a = rng.integers(0, q, size=size, dtype=np.uint64)
        b = rng.integers(0, q, size=size, dtype=np.uint64)
        wide = rng.integers(0, 1 << 64, size=size, dtype=np.uint64,
                            endpoint=False)
        s = int(rng.integers(0, q))
        if name == "_as_u64":
            outs += [mod._as_u64(a.astype(np.int64)), mod._as_u64(list(a)),
                     mod._as_u64(a)]
        elif name == "_errstate":
            with mod._errstate():
                outs.append(np.array(sorted(np.geterr().items())))
                outs.append(wide * wide)
        elif name == "compare":
            outs += [mod.compare(c, wide, s) for c in mod.ALL_CMPS]
        elif name == "mulhi64":
            outs.append(mod.mulhi64(wide, wide[::-1].copy()))
        elif name == "mullo64":
            outs.append(mod.mullo64(wide, wide[::-1].copy()))
        elif name == "reduce_mod_lazy":
            outs += [mod.reduce_mod_lazy(wide % np.uint64(f * q), q, f)
                     for f in (1, 2, 4, 8) if f * q < 1 << 64]
        elif name == "multiply_mod_lazy":
            outs.append(mod.multiply_mod_lazy(
                wide % np.uint64(4 * q), s, (s << 64) // q, q))
        elif name == "barrett_reduce_64":
            outs += [mod.barrett_reduce_64(wide, q, (1 << 64) // q, omf)
                     for omf in (1, 2)]
        elif name == "eltwise_add_mod":
            outs += [mod.eltwise_add_mod(a, b, q), mod.eltwise_add_mod(a, s, q),
                     mod.eltwise_add_mod(a, np.uint64(s), q)]
        elif name == "eltwise_sub_mod":
            outs += [mod.eltwise_sub_mod(a, b, q), mod.eltwise_sub_mod(a, s, q),
                     mod.eltwise_sub_mod(a, np.uint64(s), q)]
        elif name == "eltwise_mult_mod":
            outs += [mod.eltwise_mult_mod(wide % np.uint64(f * q),
                                          b * np.uint64(f) // np.uint64(2),
                                          q, f)
                     for f in (1, 2, 4) if f * q < 1 << 63]
        elif name == "eltwise_fma_mod":
            for f in (1, 2, 4, 8):
                if f * q >= 1 << 63:
                    continue
                x = wide % np.uint64(f * q)
                outs += [mod.eltwise_fma_mod(x, s * f // 2, b, q, f),
                         mod.eltwise_fma_mod(x, s, None, q, f)]
        elif name == "eltwise_reduce_mod":
            outs += [mod.eltwise_reduce_mod(wide, q, q, omf) for omf in (1, 2)]
            outs += [mod.eltwise_reduce_mod(wide % np.uint64(f * q), q, f, omf)
                     for f, omf in ((2, 1), (4, 1), (4, 2), (2, 2))
                     if f * q < 1 << 64]
        elif name == "eltwise_cmp_add":
            outs += [mod.eltwise_cmp_add(wide, c, s, q - 1)
                     for c in mod.ALL_CMPS]
        elif name == "eltwise_cmp_sub_mod":
            outs += [mod.eltwise_cmp_sub_mod(wide, q, c, s, s % (q - 1) + 1)
                     for c in mod.ALL_CMPS]
        else:
            raise KeyError(name)
    return outs


NTT_FUNCTIONS = ["root_of_unity_powers", "precon64", "fwd_ntt_radix2",
                 "inv_ntt_radix2", "fwd_ntt_radix4", "inv_ntt_radix4",
                 "reference_fwd_ntt", "reference_inv_ntt"]
ELT_FUNCTIONS = ["_errstate", "_as_u64", "compare", "mulhi64", "mullo64",
                 "reduce_mod_lazy", "multiply_mod_lazy", "barrett_reduce_64",
                 "eltwise_add_mod", "eltwise_sub_mod", "eltwise_mult_mod",
                 "eltwise_fma_mod", "eltwise_reduce_mod", "eltwise_cmp_add",
                 "eltwise_cmp_sub_mod"]
CASES = ([(f, ("ntt",) + s) for f in NTT_FUNCTIONS for s in NTT_SHAPES]
         + [(f, ("eltwise", size)) for f in ELT_FUNCTIONS
            for size in ELT_SIZES])


def test_every_function_is_covered():
    functions = {name for name, value in vars(jax_ref).items()
                 if callable(value) and getattr(value, "__module__", "")
                 == jax_ref.__name__}
    assert functions == set(NTT_FUNCTIONS + ELT_FUNCTIONS)
    assert len(functions) == 23
    assert jax_ref.ALL_CMPS == ref.ALL_CMPS


@pytest.mark.parametrize("name,shape", CASES,
                         ids=[f"{n}-{'-'.join(map(str, s))}"
                              for n, s in CASES])
def test_matches_jax_ref(name, shape):
    if shape[0] == "ntt":
        mine, theirs = (_ntt_case(m, name, *shape[1:])
                        for m in (ref, jax_ref))
    else:
        mine, theirs = (_eltwise_case(m, name, shape[1])
                        for m in (ref, jax_ref))
    assert len(mine) == len(theirs) > 0
    for got, want in zip(mine, theirs):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
