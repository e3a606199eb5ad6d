"""Coefficient-sharded NTT over a mesh of torch devices: the scale-out path.

The counterpart of `hexl_tpu/parallel/dist_ntt.py`. A transform of degree
N over a (batch, coeff) mesh of D coeff positions gives position r the
contiguous shard r of L = N/D coefficients:

  forward:  exchange (all-to-all over the coeff axis) -> the log2(D) cross
            stages on the regrouped (D, L/D) block -> exchange back ->
            the local sub-transform of the shard (strides < L), with the
            OMF reduction;
  inverse:  the local sub-transform, then the cross pass with the global
            final stage x N^-1 and the OMF reduction.

Every butterfly runs in a kernel on the card: the cross stages in K5 with a
column stride (`ntt/hier.py::cross`, two launches for D > 64), the local
sub-transform in K6 with a shard base (and K5 for a shard's stages of
stride >= 2^14 when L > 2^14), the port of the TPU kernel
`DistNTT._pallas_local` (`ntt/shard.py`). The plain versions run on
CPU positions. The exchanges are copies (`mesh.all_to_all`). With D = 1 the
transform is the single-device 64-bit one (`cuda_ntt` with word 64), which
is bit-equal; the layer is 64-bit for every q, as the JAX package's is
(the public `NTT` would take the single word for q < 2^30, whose lazy
outputs differ).

Outputs are bit-equal to the JAX package's `DistNTT` on the CPU, lazy ones
included (its CPU bodies are the exact Harvey butterflies). With
`local_scheme="approx"` the local pass runs the approximate quotient of
the TPU kernel `_pallas_local` (q < 2^61; K6.approx) and the cross pass
stays exact, as the JAX package's does: the outputs are then those of its
Pallas route, lazy ones included.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _device, config
from ..eltwise import ops
from ..limb import to_numpy
from ..ntt import cuda_ntt, hier, shard, torch_ntt
from ..ntt.plan import get_plan, register_clear_hook
from .mesh import (Mesh, Sharded, all_to_all, gather, local,
                   mesh_devices, scatter)

LANES = 128     # the JAX layout's lane count: a shard holds at least 2 x 128


def make_mesh(n_coeff: int, n_batch: int = 1, devices=None) -> Mesh:
    """A (batch, coeff) mesh over `devices`, a flat list of at least
    n_coeff * n_batch devices (repeats allowed: several positions on one
    device). None means CUDA devices 0 .. n_coeff * n_batch - 1, which the
    host must have."""
    devs = mesh_devices(n_coeff * n_batch, devices)
    return Mesh([devs[b * n_coeff:(b + 1) * n_coeff] for b in range(n_batch)],
                ("batch", "coeff"))


class DistNTT:
    """NTT with the coefficient axis sharded over `mesh`'s 'coeff' axis."""

    def __init__(self, degree: int, modulus: int, mesh: Mesh,
                 overlap_slices: Optional[int] = None,
                 local_scheme: str = "exact"):
        """local_scheme: the local pass's butterflies, "exact" or
        "approx" (`ntt.shard.local`). overlap_slices: run each cross-phase
        exchange as this many
        slices of the chunk axis, each with its own pair of exchanges.
        None reads HEXL_TPU_DIST_OVERLAP; <= 1 keeps one exchange. The
        option is kept for the JAX signature and its results are the
        same; it overlaps nothing here: the slices run one after another
        on each device's stream (no asynchronous collective to hide), so
        it only adds copies and launches."""
        self.mesh = mesh
        self.n = degree
        self.q = modulus
        self.d = mesh.shape["coeff"]
        if overlap_slices is None:
            overlap_slices = config.dist_overlap_slices()
        self.overlap_slices = max(1, int(overlap_slices))
        if degree % (self.d * self.d) != 0:
            raise ValueError("degree must be divisible by D^2")
        self.local_n = degree // self.d
        if self.local_n < 2 * LANES:
            raise ValueError("local shard too small; reduce coeff axis")
        self.plan = get_plan(degree, modulus)
        torch_ntt.check_harvey(local_scheme, modulus, "the local pass")
        self.local_scheme = local_scheme

    # -- the passes on mesh values -------------------------------------------

    def _slice_count(self, lc: int) -> int:
        """Slices of the cross phase: the most, up to overlap_slices, that
        divide lc."""
        s = self.overlap_slices
        while s > 1 and lc % s != 0:
            s -= 1
        return max(1, s)

    def _cross(self, x: Sharded, forward: bool, omf: int) -> Sharded:
        """The cross pass: per batch row and slice of the chunk axis, the
        exchange, K5 at every position, and the exchange back."""
        d, lc = self.d, self.local_n // self.d
        s = self._slice_count(lc)
        step = lc // s
        parts = []
        for b, row in enumerate(x.parts):
            devices = list(self.mesh.devices[b])
            blocks = [p.reshape(*p.shape[:-1], d, lc) for p in row]
            slices = []
            for i in range(s):
                piece = all_to_all([blk[..., i * step:(i + 1) * step]
                                    for blk in blocks], devices)
                piece = [hier.cross(v, self.plan, forward, omf)
                         for v in piece]
                slices.append(all_to_all(piece, devices))
            out = slices[0] if s == 1 else [
                torch.cat([sl[r] for sl in slices], dim=-1) for r in range(d)]
            parts.append([v.reshape(*v.shape[:-2], self.local_n)
                          for v in out])
        return Sharded(self.mesh, parts, x.batch_axis)

    def _local(self, x: Sharded, forward: bool, omf: int) -> Sharded:
        return Sharded(self.mesh, [
            [shard.local(p, self.plan, r, self.d, forward, omf,
                         self.local_scheme)
             for r, p in enumerate(row)] for row in x.parts], x.batch_axis)

    def _forward(self, x: Sharded, omf: int) -> Sharded:
        if self.d == 1:
            omf = 1 if omf == 1 else 4
            return local(lambda p: cuda_ntt.fwd_ntt(
                p, self.plan, 1, omf, 64, self.local_scheme), x)
        return self._local(self._cross(x, True, omf), True, omf)

    def _inverse(self, x: Sharded, omf: int) -> Sharded:
        if self.d == 1:
            omf = 1 if omf == 1 else 2
            return local(lambda p: cuda_ntt.inv_ntt(
                p, self.plan, 1, omf, 64, self.local_scheme), x)
        return self._cross(self._local(x, False, omf), False, omf)

    def _poly_mult(self, a: Sharded, b: Sharded) -> Sharded:
        """fwd(a), fwd(b) to [0, 4q), mult_mod at IMF 4 per shard (K4),
        the inverse to [0, q)."""
        fa, fb = self._forward(a, 4), self._forward(b, 4)
        prod = local(lambda u, v: ops.mult_mod(u, v, self.q, 4), fa, fb)
        return self._inverse(prod, 1)

    # -- public API -----------------------------------------------------------

    def _operands(self, values):
        tensors, host = _device.operands(values, self.mesh.devices.flat[0])
        for t in tensors:
            if t.dim() < 1 or t.shape[-1] != self.n:
                raise ValueError(f"last dimension must be N={self.n}, got "
                                 f"{tuple(t.shape)}")
        return tensors, host

    def _apply(self, x, batch_shard: bool, fn):
        if isinstance(x, Sharded):
            return fn(x)
        (t,), host = self._operands((x,))
        axis = 0 if batch_shard and t.dim() > 1 else None
        out = gather(fn(scatter(t, self.mesh, axis)), t.device)
        return to_numpy(out) if host else out

    def poly_mult(self, a, b):
        """Sharded negacyclic product c = a*b mod (X^N+1, q); inputs
        (batch..., N) in [0, q), the leading dim over the batch rows."""
        if isinstance(a, Sharded):
            return self._poly_mult(a, b)
        (ta, tb), host = self._operands((a, b))
        if ta.shape != tb.shape:
            raise ValueError(f"operands of shapes {tuple(ta.shape)} and "
                             f"{tuple(tb.shape)}")
        axis = 0 if ta.dim() > 1 else None
        out = gather(self._poly_mult(scatter(ta, self.mesh, axis),
                                     scatter(tb, self.mesh, axis)), ta.device)
        return to_numpy(out) if host else out

    def forward(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1, batch_shard: bool = True):
        """Sharded forward NTT of x (batch..., N): numpy uint64 in, numpy
        out; an int64 tensor in, a tensor out on its device; a Sharded value
        in (a composite's intermediate), a Sharded value out."""
        return self._apply(x, batch_shard,
                           lambda v: self._forward(v, output_mod_factor))

    def inverse(self, x, input_mod_factor: int = 1,
                output_mod_factor: int = 1, batch_shard: bool = True):
        return self._apply(x, batch_shard,
                           lambda v: self._inverse(v, output_mod_factor))


# ---------------------------------------------------------------------------
# RNS: the north-star pipeline (BASELINE.md), per-prime sharded negacyclic
# products over a (batch, coeff) mesh; each prime has its own DistNTT.
# ---------------------------------------------------------------------------

_DIST_CACHE = {}


def get_dist_ntt(degree: int, modulus: int, mesh: Mesh) -> DistNTT:
    key = (degree, modulus, mesh.key(), max(1, config.dist_overlap_slices()))
    if key not in _DIST_CACHE:
        _DIST_CACHE[key] = DistNTT(degree, modulus, mesh)
    return _DIST_CACHE[key]


register_clear_hook(_DIST_CACHE.clear)


def dist_rns_poly_mult(a, b, degree: int, moduli, mesh: Mesh):
    """c_i = a_i * b_i over Z_{q_i}[X]/(X^N + 1) for each RNS prime q_i.

    a, b: (num_primes, batch..., N) residue stacks (numpy uint64, or int64
    tensors); each prime runs the sharded product (DistNTT.poly_mult)."""
    moduli = [int(q) for q in moduli]
    (ta, tb), host = _device.operands((a, b), mesh.devices.flat[0])
    if ta.shape != tb.shape or ta.dim() < 2 or ta.shape[0] != len(moduli):
        raise ValueError(
            f"operands must both have shape ({len(moduli)}, ..., {degree})")
    out = torch.stack([get_dist_ntt(degree, q, mesh).poly_mult(ta[i], tb[i])
                       for i, q in enumerate(moduli)])
    return to_numpy(out) if host else out
