"""One call pair of the stacked RNS transform: `RnsNTT.forward` then
`RnsNTT.inverse`, at input and output mod factors of 1, on (k, polys,
N): the configuration's k data primes (all but the key prime) and polys
= 2 x the traffic's ciphertexts. The inputs are a pool of residue
tensors, uniform mod each prime, made from the seed on the device and
drawn in turn."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from hebench import reference as ref
from hebench.inputs import uniform_rows

UNIT = "limb pair"
OUTPUTS = ("fwd", "inv")
LIMITS = {"fwd_mismatch": 0, "inv_mismatch": 0}


def setup(ctx) -> SimpleNamespace:
    import hexl_tpu_torch as program

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n = int(cfg["poly_modulus_degree"])
    moduli = [int(q) for q in cfg["moduli"][:-1]]
    polys, pool = 2 * int(tr["ciphertexts"]), int(tr["pool"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed)
    x = uniform_rows(gen, moduli, (pool, len(moduli), polys, n), 1, dev)
    with ctx.span("plan_setup"):
        rns = program.RnsNTT(n, moduli, device=dev)
    return SimpleNamespace(n=n, moduli=moduli, polys=polys, pool=pool, x=x,
                           rns=rns, device=dev, tables=None)


def key(st, i: int) -> int:
    return i % st.pool


def call(st, i: int):
    y = st.rns.forward(st.x[key(st, i)])
    return y, st.rns.inverse(y)


def units(st) -> int:
    return len(st.moduli) * st.polys


def shape(st) -> dict:
    """The call's shape, as `roofline/ntt_pair.py::counts` takes it."""
    return dict(n=st.n, rows=len(st.moduli), polys=st.polys)


def release(st) -> None:
    st.rns = None


def reference(st, k, mul=ref.mulmod):
    """The outputs of the call pair on pool entry k, from the plain
    reference with the modular product `mul`."""
    if st.tables is None:
        st.tables = ref.Tables(st.n, st.moduli, st.device)
    y = ref.forward(st.x[k], st.tables, mul)
    return y, ref.inverse(y, st.tables, mul)

