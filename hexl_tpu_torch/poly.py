"""Negacyclic polynomial products, and the wrapper of kernel K3.

poly_mult_mod computes c = a*b over Z_q[X]/(X^N + 1) as fwd(a) and fwd(b)
to [0,4q), mult_mod at IMF 4, then the inverse to [0,q), the counterpart of
`hexl_tpu/poly.py::poly_mult_mod`. For N <= 2^14 the whole chain is one
launch of K3 (`csrc/poly.cu`) on the GPU, which replaces the TPU kernel
`hexl_tpu/poly.py::_poly_mult_pallas`; its source note says what bounds it
on an H100 and what each form does about it. On the CPU it runs the plain
chain (`poly_mult_plain`, the counterpart of `_poly_mult_xla`).

K3 has two forms, both one launch with nothing in device memory between
the transforms, and `form_for` picks one per call:

| N | 2 batch <= SMs | 2 batch > SMs |
|---|---|---|
| 2^14 | cluster | cluster |
| 2^12, 2^13 | cluster | one-CTA |
| 2 .. 2^11 | one-CTA | one-CTA |

The cluster form ("K3") gives each pair two CTAs on two SMs, each CTA the
forward of one operand and the inverse of half the product, reading the
other's transform through distributed shared memory; the one-CTA form
("K3.cta") holds both operands in one CTA (16N bytes, N <= 2^13). The
table is the card's (K3 form rows of `chip_smoke.py`, one H100 80GB HBM3
at 700 W, PERF.md). Above 2^14 both devices run the staged
route of `_poly_mult_staged` (poly.py:83-90): the 64-bit transforms of
`cuda_ntt` (K5/K6 on the GPU, even for q < 2^30, as the JAX package's are)
and the mult_mod of K4. Launches are counted in `_build.launches` under
the form's name (and the kernels of the staged route under theirs). Where
`config.approx_butterflies` says so, the staged route's transforms run the
approximate-quotient butterflies that the modulus (for an RNS basis, its
largest, as the JAX stacked pipeline does) allows; K3 and the plain chain
stay exact. Every output is fully reduced, so the scheme changes no bit
of it.

rns_poly_mult_mod runs the same product per prime of an RNS basis, the
counterpart of `hexl_tpu/poly.py::rns_poly_mult_mod`; every output is fully
reduced, so it equals the JAX package's stacked pipeline bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _device, nt
from .eltwise import ops, torch_kernels
from .limb import to_numpy
from .ntt import cuda_ntt, get_plan, torch_ntt

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_POLY_ARGS = (_P, _P, _P, _P, _P, _P, _P, _U, _U, _I, _U, _U, _U, _U, _I, _I,
              _I, _P)

# K3's forms (csrc/poly.cu) and their launch names.
FORMS = {"cluster": "K3", "cta": "K3.cta"}
_FORM_CODE = {"cluster": 0, "cta": 1}
CLUSTER_DEGREES = (1 << 12, 1 << 14)  # the cluster form's least and most N
MAX_CTA_DEGREE = 1 << 13              # the one-CTA form holds 16N bytes


def form_for(degree: int, batch: int, sms: int) -> str:
    """K3's form for `batch` products of `degree` on a card of `sms` SMs
    (the module's table): the cluster at 2^14, and at 2^12-2^13 while its
    2 x batch CTAs fit the card's SMs one each; the one-CTA form
    otherwise."""
    if degree > MAX_CTA_DEGREE or (degree >= CLUSTER_DEGREES[0]
                                   and 2 * batch <= sms):
        return "cluster"
    return "cta"


def forms_of(degree: int) -> list:
    """The forms K3 takes at `degree`."""
    lo, hi = CLUSTER_DEGREES
    return [f for f in FORMS if (f == "cta" and degree <= MAX_CTA_DEGREE)
            or (f == "cluster" and lo <= degree <= hi)]


def poly_mult_plain(a: torch.Tensor, b: torch.Tensor, plan) -> torch.Tensor:
    """The plain chain: fwd (OMF 4) of both, mult_mod at IMF 4, inverse."""
    fa = torch_ntt.fwd_ntt(a, plan, 1, 4)
    fb = torch_ntt.fwd_ntt(b, plan, 1, 4)
    prod = torch_kernels.mult_mod(fa, fb, plan.q, 4)
    return torch_ntt.inv_ntt(prod, plan, 1, 1)


def poly_mult_staged(a: torch.Tensor, b: torch.Tensor, plan,
                     scheme: str = "exact") -> torch.Tensor:
    """The same chain through the transform and mult_mod wrappers, one
    launch per step on the GPU: the route above 2^14. The transforms run
    the butterflies of `scheme`; the product is fully reduced either
    way."""
    fa = cuda_ntt.fwd_ntt(a, plan, 1, 4, 64, scheme)
    fb = cuda_ntt.fwd_ntt(b, plan, 1, 4, 64, scheme)
    prod = ops.mult_mod(fa, fb, plan.q, 4)
    return cuda_ntt.inv_ntt(prod, plan, 1, 1, 64, scheme)


def poly_mult(a: torch.Tensor, b: torch.Tensor, plan,
              scheme: str = "exact") -> torch.Tensor:
    """a*b mod (X^N+1, q) on int64 tensors (..., N) of one shape and
    device: K3 (N <= 2^14, in `form_for`'s form) or the staged route on
    the GPU, the plain chain on the CPU. `scheme` is the staged route's
    (K3 and the plain chain are exact)."""
    if a.shape != b.shape or a.dim() < 1 or a.shape[-1] != plan.n:
        raise ValueError(f"operands must both have shape (..., {plan.n})")
    if plan.n > cuda_ntt.MAX_KERNEL_DEGREE:
        return poly_mult_staged(a, b, plan, scheme)
    if not _build.on_card(a, b):
        return poly_mult_plain(a, b, plan)
    out = torch.empty_like(a)
    batch = _build.batch_of(a, plan.n)
    if batch == 0:
        return out
    form = form_for(plan.n, batch, cuda_ntt.sm_count(a.device))
    mu, shift = nt.barrett_mult_constants(plan.q)
    tabs = plan.tables(a.device)
    fin = (plan.inv_n, plan.inv_n_precon, plan.inv_n_w, plan.inv_n_w_precon)
    fn = _build.function("poly", "hexl_poly_mult", _POLY_ARGS)
    _build.launch_on(a.device, FORMS[form], fn, a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), tabs["rop"].data_ptr(),
                     tabs["prop"].data_ptr(), tabs["irop"].data_ptr(),
                     tabs["pirop"].data_ptr(), plan.q, mu, shift, *fin,
                     plan.log_n, batch, _FORM_CODE[form])
    return out


def max_active_clusters(degree: int, device) -> int:
    """How many of the cluster form's clusters at `degree` the card can
    hold at once (cudaOccupancyMaxActiveClusters)."""
    if "cluster" not in forms_of(degree):
        raise ValueError(f"K3's cluster form does not take N={degree}")
    count = ctypes.c_int(0)
    fn = _build.function("poly", "hexl_poly_max_active_clusters",
                         (_I, ctypes.POINTER(ctypes.c_int)))
    with torch.cuda.device(device):
        err = fn(degree.bit_length() - 1, ctypes.byref(count))
    if err:
        raise RuntimeError(f"hexl_tpu_torch: the cluster occupancy query "
                           f"failed with cudaError {err}")
    return count.value


def poly_mult_mod(a, b, degree: int, modulus: int, device=None):
    """c = a * b over Z_q[X]/(X^N + 1); inputs (..., N) in [0, q).

    int64 tensors of u64 bits run on their device; numpy uint64 operands
    run there too, else on `device` (default CUDA). The result is numpy iff
    an operand was numpy, as in the JAX package."""
    if degree < 2:
        raise ValueError("degree must be at least 2")
    (ta, tb), host = _device.operands((a, b), device)
    out = poly_mult(ta, tb, get_plan(degree, modulus),
                    torch_ntt.scheme_for(modulus, degree, ta.device))
    return to_numpy(out) if host else out


def rns_poly_mult_mod(a, b, degree: int, moduli, device=None):
    """Per-prime negacyclic products: a, b shaped (num_primes, ..., N) with
    residues mod moduli[i] along the leading axis, in [0, moduli[i]);
    returns the same shape. Operands and devices as in `poly_mult_mod`."""
    moduli = [int(q) for q in moduli]
    if degree < 2:
        raise ValueError("degree must be at least 2")
    (ta, tb), host = _device.operands((a, b), device)
    if ta.shape != tb.shape or ta.dim() < 2 or ta.shape[0] != len(moduli):
        raise ValueError(
            f"operands must both have shape ({len(moduli)}, ..., {degree})")
    scheme = torch_ntt.scheme_for(max(moduli), degree, ta.device)
    out = torch.stack([poly_mult(ta[i], tb[i], get_plan(degree, q), scheme)
                       for i, q in enumerate(moduli)])
    return to_numpy(out) if host else out
