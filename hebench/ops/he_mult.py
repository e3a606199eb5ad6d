"""One homomorphic multiply: SEAL's `multiply` then `relinearize` of two
CKKS ciphertexts in NTT form at the top level, through the program's
public API: `dyadic_multiply(ct_a, ct_b, moduli)` gives three components,
and `key_switch` switches the third with the relinearisation keys into
the first two, giving the (2, ds, N) result.

The traffic names the pool of independent ciphertext pairs the server
holds, drawn in turn. Residues, keys and the modswitch factors qk^-1 mod
q_i are made here from the seed, the residues and keys on the device; the
program receives only these inputs.
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
    ds, kc = int(ks["decomp_modulus_size"]), int(ks["key_component_count"])
    if ds + 1 != int(ks["key_modulus_size"]) or len(moduli) != ds + 1:
        raise ValueError("the configuration's key switch does not take "
                         "every modulus at the top level")
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    pool = int(tr["pool"])
    cts = uniform_rows(gen, moduli[:ds], (pool, 2, 2, ds, n), 3, dev)
    # keys[j, k, m] is uniform mod moduli[m].
    keys = uniform_rows(gen, moduli, (ds, kc, ds + 1, n), 2, dev)
    with ctx.span("plan_setup"):
        for q in moduli:
            get_plan(n, q, dev)
        get_rns_plan(n, moduli[:ds], dev)
    return SimpleNamespace(n=n, ds=ds, kc=kc, pool=pool, moduli=moduli,
                           cts=cts, keys=keys,
                           msf=[pow(moduli[-1], -1, q) for q in moduli[:ds]],
                           device=dev, tables=None,
                           dyadic=program.dyadic_multiply,
                           key_switch=program.key_switch)


def key(st, i: int) -> int:
    """The pair of call i."""
    return i % st.pool


def call(st, i: int):
    p = key(st, i)
    prod = st.dyadic(st.cts[p, 0], st.cts[p, 1], st.moduli[:st.ds])
    out = st.key_switch(prod[:2], prod[2], st.n, st.ds, st.ds + 1,
                        st.ds + 1, st.kc, st.moduli, st.keys, st.msf)
    return prod, out


def units(st) -> int:
    return 1


def shape(st) -> dict:
    """The call's shape, as `roofline/he_mult.py::counts` takes it."""
    return dict(n=st.n, ds=st.ds, kms=st.ds + 1, kc=st.kc)


def release(st) -> None:
    """Drop what belongs to the program; the inputs are the benchmark's."""
    st.dyadic = st.key_switch = None


def reference(st, p: int, mul=ref.mulmod):
    """The outputs of the call on pair p, from the plain reference with
    the modular product `mul`."""
    if st.tables is None:
        st.tables = ref.Tables(st.n, st.moduli, st.device)
    data = st.tables.rows(range(st.ds))
    prod = ref.dyadic(st.cts[p, 0], st.cts[p, 1], data.q, data.bits, mul)
    out = ref.key_switch(prod[:2], prod[2], st.keys, st.msf, st.tables, mul)
    return prod, out
