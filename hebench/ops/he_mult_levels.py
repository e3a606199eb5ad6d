"""One homomorphic multiply at each level of a CKKS chain: SEAL's
`multiply` then `relinearize` of two ciphertexts in NTT form at level ds
(the first ds primes of the basis), through the program's public API:
`dyadic_multiply(ct_a, ct_b, moduli[:ds])` gives three components, and
`key_switch` switches the third with keys[:ds] of the top level's
relinearisation key (kms = every modulus, the key prime last) into the
first two, giving the (2, ds, N) result. The rescale between levels is
not part of it: each level's pairs are drawn from the seed.

Call i runs at level `levels[i % L]` (the traffic's L levels in turn) on
pair `(i // L) % pool_per_level` of that level's pool. Residues, keys and
the modswitch factors qk^-1 mod q_i are made here from the seed, the
residues and keys on the device; the program receives only these inputs.
Set-up calls every level twice, so that the program's graph of each
level's key switch (eager, then captured) exists before the window.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from hebench import reference as ref
from hebench.inputs import uniform_rows

UNIT = "mult"
OUTPUTS = ("prod", "relin")
LIMITS = {"prod_mismatch": 0, "relin_mismatch": 0}


def setup(ctx) -> SimpleNamespace:
    import hexl_tpu_torch as program
    from hexl_tpu_torch.ntt import get_plan, get_rns_plan

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n = int(cfg["poly_modulus_degree"])
    moduli = [int(q) for q in cfg["moduli"]]
    ks = cfg["key_switch"]
    top, kms = int(ks["decomp_modulus_size"]), int(ks["key_modulus_size"])
    kc = int(ks["key_component_count"])
    levels = [int(d) for d in tr["levels"]]
    if kms != len(moduli) or top + 1 != kms \
            or not set(levels) <= set(int(d) for d in cfg["levels"]) \
            or not all(1 <= d <= top for d in levels):
        raise ValueError("the traffic's levels or the configuration's key "
                         "switch do not fit the basis")
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    pool = int(tr["pool_per_level"])
    cts = {d: uniform_rows(gen, moduli[:d], (pool, 2, 2, d, n), 3, dev)
           for d in levels}
    # keys[j, k, m] is uniform mod moduli[m]; level d takes keys[:d].
    keys = uniform_rows(gen, moduli, (top, kc, kms, n), 2, dev)
    msf = [pow(moduli[-1], -1, q) for q in moduli[:top]]
    with ctx.span("plan_setup"):
        for q in moduli:
            get_plan(n, q, dev)
        for d in levels:
            get_rns_plan(n, moduli[:d], dev)
    st = SimpleNamespace(n=n, kms=kms, kc=kc, levels=levels, pool=pool,
                         moduli=moduli, cts=cts, keys=keys,
                         at={d: (moduli[:d], keys[:d], msf[:d])
                             for d in levels},
                         device=dev, tables=None,
                         dyadic=program.dyadic_multiply,
                         key_switch=program.key_switch)
    for i in range(2 * len(levels)):
        call(st, i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def key(st, i: int) -> tuple:
    """The (level, pair) of call i."""
    count = len(st.levels)
    return st.levels[i % count], (i // count) % st.pool


def call(st, i: int):
    d, p = key(st, i)
    q, keys, msf = st.at[d]
    ct = st.cts[d][p]
    prod = st.dyadic(ct[0], ct[1], q)
    out = st.key_switch(prod[:2], prod[2], st.n, d, st.kms, d + 1, st.kc,
                        st.moduli, keys, msf)
    return prod, out


def units(st) -> int:
    return 1


def shape(st) -> dict:
    """The calls' shape, as `roofline/he_mult_levels.py::counts` takes
    it."""
    return dict(n=st.n, levels=tuple(st.levels), kc=st.kc)


def release(st) -> None:
    """Drop what belongs to the program; the inputs are the benchmark's."""
    st.dyadic = st.key_switch = None


def reference(st, k: tuple, mul=ref.mulmod):
    """The outputs of the call at level and pair k, from the plain
    reference with the modular product `mul`."""
    d, p = k
    if st.tables is None:
        st.tables = ref.Tables(st.n, st.moduli, st.device)
    data = st.tables.rows(range(d))
    ct = st.cts[d][p]
    _, keys, msf = st.at[d]
    prod = ref.dyadic(ct[0], ct[1], data.q, data.bits, mul)
    out = ref.key_switch(prod[:2], prod[2], keys, msf, st.tables, mul)
    return prod, out
