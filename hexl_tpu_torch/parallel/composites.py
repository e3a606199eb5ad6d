"""Mesh-sharded composites: the dyadic multiply and the CKKS key switch.

The counterpart of `hexl_tpu/parallel/composites.py`. The coefficient axis
is sharded over the mesh's 'coeff' axis: every NTT runs through `DistNTT`
(two exchanges per cross pass) and every element-wise segment between the
transforms runs at each position on its shard, through the single-device
wrappers (K8 reduce, K9 dyadic, K10 multiply-accumulate and flush, K11
spread and fold; their plain versions on CPU positions). Values stay on the
mesh (`Sharded`) from the scatter of the operands to the gather of the
result. The key switch's modulus-count axes are replicated over the batch
rows, as in the JAX package (batch_shard=False): each batch row computes
the same values. Outputs are bit-equal to the single-device composites
(`experimental.dyadic_multiply`, `experimental.key_switch`), which are
bit-equal to the JAX package's.
"""

from __future__ import annotations

import functools
import importlib
from types import SimpleNamespace
from typing import Sequence

import torch

from .. import _device
from ..limb import to_numpy
from .dist_ntt import get_dist_ntt
from .mesh import Mesh, Sharded, gather, local, scatter

# The modules (their names are shadowed by functions in experimental/).
_dyadic = importlib.import_module("hexl_tpu_torch.experimental.dyadic")
_ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")


def dist_dyadic_multiply(operand1, operand2, moduli, mesh: Mesh):
    """Coefficient-sharded ct x ct dyadic multiply over an RNS basis.

    operand1/2: (2, num_moduli, n); output (3, num_moduli, n). The
    modulus axis goes over the batch rows when it divides them (else it is
    replicated): each position runs K9 on its moduli and coefficients."""
    moduli = tuple(int(q) for q in moduli)
    (x, y), host = _device.operands((operand1, operand2),
                                    mesh.devices.flat[0])
    m = len(moduli)
    if x.shape != y.shape or x.dim() != 3 or tuple(x.shape[:2]) != (2, m):
        raise ValueError(f"operands must both have shape (2, {m}, n), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    dp = mesh.shape.get("batch", 1)
    mod_axis = 1 if dp > 1 and m % dp == 0 else None
    rows = m // dp if mod_axis else m
    sx, sy = scatter(x, mesh, mod_axis), scatter(y, mesh, mod_axis)
    out = Sharded(mesh, [
        [_dyadic.dyadic(px.unsqueeze(0), py.unsqueeze(0),
                        moduli[b * rows:(b + 1) * rows] if mod_axis
                        else moduli)
         for px, py in zip(sx.parts[b], sy.parts[b])]
        for b in range(dp)], mod_axis)
    out = gather(out, x.device)
    return to_numpy(out) if host else out


def _mesh_steps(mesh: Mesh) -> SimpleNamespace:
    """The key switch's steps over Sharded values: the transforms through
    DistNTT, every other step at each position on its parts."""
    steps = _ks.WRAPPERS

    def take(x, i):
        return local(lambda p: p[i], x)

    return SimpleNamespace(
        plan=lambda n, q: get_dist_ntt(n, q, mesh),
        constants=lambda moduli, msf, ds, like: functools.partial(
            _ks.constants, moduli, msf, ds),
        take=take, stack=lambda xs: local(torch.stack, xs),
        unbind=lambda x: [take(x, i) for i in range(x.parts[0][0].shape[0])],
        fwd=lambda x, d, imf, omf: d.forward(x, imf, omf),
        inv=lambda x, d, imf, omf: d.inverse(x, imf, omf),
        reduce=lambda x, q: local(lambda p: steps.reduce(p, q), x),
        mac_flush=lambda t, keys, c, ds, kc, kms: local(
            lambda tp, k: steps.mac_flush(tp, k, c(k.device), ds, kc, kms),
            t, keys),
        spread=lambda x, c: local(lambda p: steps.spread(p, c(p.device)), x),
        fold=lambda res, tpp, tn, c: local(
            lambda r, tp, t: steps.fold(r, tp, t, c(r.device)), res, tpp, tn))


def dist_key_switch(result, t_target, n: int, decomp_modulus_size: int,
                    key_modulus_size: int, rns_modulus_size: int,
                    key_component_count: int, moduli: Sequence[int],
                    key_switch_keys, modswitch_factors: Sequence[int],
                    mesh: Mesh):
    """CKKS key switch with the coefficient axis sharded over `mesh`.

    Same signature, semantics and lazy-range chaining as
    `experimental.key_switch`: its `pipeline`, with every NTT through
    `DistNTT` and the other steps at each position. Operands and the
    result as there: numpy in (result or t_target), numpy out."""
    (r, t, keys, *rest), host = _ks.arguments(
        result, t_target, n, decomp_modulus_size, key_modulus_size,
        rns_modulus_size, key_component_count, moduli, key_switch_keys,
        modswitch_factors, mesh.devices.flat[0])
    sharded = (scatter(v, mesh, None) for v in (r, t, keys))
    out = gather(_ks.pipeline(_mesh_steps(mesh), *sharded, *rest), r.device)
    return to_numpy(out) if host else out
