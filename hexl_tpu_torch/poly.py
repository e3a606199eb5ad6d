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
`config.approx_butterflies` says so, every route runs the approximate-
quotient butterflies that the modulus (for an RNS basis, its largest, as
the JAX stacked pipeline does) allows, as the JAX package's XLA body
`_poly_mult_xla` does (poly.py:93-97): lean16 or lean8 (`torch_ntt.
scheme_for`), K3 too (launches "K3.lean16", "K3.lean8", "K3.cta.lean16",
"K3.cta.lean8"). Both forms of K3 and the plain chain also run the
"approx" scheme, the butterflies the TPU kernel `_poly_mult_pallas` runs
for q < 2^61 (launches "K3.approx", "K3.cta.approx"). In every scheme but
the exact one, K3's and the plain chain's mult_mod takes the approximate
Barrett quotient, as the JAX bodies' `K.mult_mod` does under the switch.
Every output is fully reduced, so the scheme changes no bit of it.

rns_poly_mult_mod runs the same product over an RNS basis, the counterpart
of `hexl_tpu/poly.py::rns_poly_mult_mod`: for k > 1 distinct primes the
JAX package's stacked pipeline (`_jitted_rns_poly_mult`), two stacked
forwards over the whole basis (`ntt.rns`: K1.rns/K2.rns, or K5.rns and
K6.rns above 2^14), the pointwise product of every row in one K4.rows
launch and one stacked inverse, where `rns_route` picks it; otherwise, and
for a repeated prime or k = 1, `poly_mult` per prime. Every output is fully
reduced, so both routes equal the JAX package's bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _device, nt
from .eltwise import ops, torch_kernels
from .limb import to_numpy
from .ntt import cuda_ntt, get_plan, rns, torch_ntt

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_POLY_ARGS = (_P, _P, _P, _P, _P, _P, _P, _U, _U, _I, _U, _U, _U, _U, _I, _I,
              _I, _I, _P)

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


def poly_mult_plain(a: torch.Tensor, b: torch.Tensor, plan,
                    scheme: str = "exact") -> torch.Tensor:
    """The plain chain: fwd (OMF 4) of both, mult_mod at IMF 4, inverse;
    the transforms in `scheme`, the mult_mod with the approximate quotient
    in every scheme but "exact" (`_poly_mult_xla` under the switch)."""
    fa = torch_ntt.fwd_ntt(a, plan, 1, 4, 64, scheme)
    fb = torch_ntt.fwd_ntt(b, plan, 1, 4, 64, scheme)
    prod = torch_kernels.mult_mod(fa, fb, plan.q, 4, scheme != "exact")
    return torch_ntt.inv_ntt(prod, plan, 1, 1, 64, scheme)


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
    the GPU, the plain chain on the CPU, every one in `scheme`."""
    if a.shape != b.shape or a.dim() < 1 or a.shape[-1] != plan.n:
        raise ValueError(f"operands must both have shape (..., {plan.n})")
    torch_ntt.check_scheme(scheme, plan.q)
    if plan.n > cuda_ntt.MAX_KERNEL_DEGREE:
        return poly_mult_staged(a, b, plan, scheme)
    if not _build.on_card(a, b):
        return poly_mult_plain(a, b, plan, scheme)
    out = torch.empty_like(a)
    batch = _build.batch_of(a, plan.n)
    if batch == 0:
        return out
    form = form_for(plan.n, batch, cuda_ntt.sm_count(a.device))
    mu, shift = nt.barrett_mult_constants(plan.q)
    tabs = plan.tables(a.device)
    fin = (plan.inv_n, plan.inv_n_precon, plan.inv_n_w, plan.inv_n_w_precon)
    fn = _build.function("poly", "hexl_poly_mult", _POLY_ARGS)
    name = FORMS[form] + ("" if scheme == "exact" else f".{scheme}")
    _build.launch_on(a.device, name, fn, a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), tabs["rop"].data_ptr(),
                     tabs["prop"].data_ptr(), tabs["irop"].data_ptr(),
                     tabs["pirop"].data_ptr(), plan.q, mu, shift, *fin,
                     plan.log_n, batch, _FORM_CODE[form],
                     torch_ntt.SCHEME_CODE[scheme])
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
    """c = a * b over Z_q[X]/(X^N + 1); inputs (..., N) in [0, q), their
    leading axes broadcast against each other.

    int64 tensors of u64 bits run on their device; numpy uint64 operands
    run there too, else on `device` (default CUDA). The result is numpy iff
    an operand was numpy, as in the JAX package."""
    if degree < 2:
        raise ValueError("degree must be at least 2")
    (ta, tb), host = _device.operands((a, b), device)
    out = poly_mult(*_broadcast_polys(ta, tb, degree),
                    get_plan(degree, modulus),
                    torch_ntt.scheme_for(modulus, degree, ta.device))
    return to_numpy(out) if host else out


def _broadcast_polys(ta: torch.Tensor, tb: torch.Tensor, degree: int):
    """Operands (..., N) broadcast against each other over their leading
    axes, as in the JAX package (many polynomials times one plaintext)."""
    for t in (ta, tb):
        if t.dim() < 1 or t.shape[-1] != degree:
            raise ValueError(f"operands must have shape (..., {degree}), "
                             f"got {tuple(t.shape)}")
    return _device.broadcast((ta, tb))


# The RNS product's routes (`rns_route`): the stacked transforms and
# K4.rows, or K3 once a prime.
RNS_ROUTES = ("stacked", "per_prime")
RNS_PER_PRIME_BATCH = 256   # the least batch at which K3 once a prime won


def rns_route(degree: int, k: int, batch: int) -> str:
    """The RNS product's route for k > 1 distinct primes of `degree` and
    `batch` products a prime: "stacked" (two stacked forwards, K4.rows,
    one stacked inverse: 4 launches for the basis at N <= 2^14, 7 above)
    or "per_prime" (`poly_mult` a prime: K3, k launches). The card's table
    (`chip_smoke.py` phase 5, RNS route rows; one H100 80GB HBM3 at 700
    W; stacked / K3 once a prime, device ms):

    | N | k | batch 1 | 8 | 64 | 256 |
    |---|---|---|---|---|---|
    | 2^12 | 2 | 0.75 | 0.78 | 0.86 | 1.11 |
    | 2^12 | 4 | 0.39 | 0.42 | 0.64 | 1.04 |
    | 2^12 | 16 | 0.10 | 0.12 | 0.52 | 0.96 |
    | 2^13 | 2 | 0.85 | 0.86 | 0.97 | 1.18 |
    | 2^13 | 4 | 0.44 | 0.46 | 0.89 | 1.11 |
    | 2^13 | 16 | 0.11 | 0.14 | 0.83 | 1.04 |
    | 2^14 | 2-16 | 0.12-0.89 | 0.14-0.89 | 0.92-0.97 | 0.93-0.97 |

    K3 once a prime wins only where its fusion (a third of the stacked
    route's bytes) outweighs k launches of its own: at 2^12 and 2^13 from
    batch 256 (not at 2^12 with 16 primes); the stacked route everywhere
    else, and above 2^14, where there is no K3. Between batch 64 and 256,
    and below 2^12, the card was not asked: the stacked route."""
    if batch >= RNS_PER_PRIME_BATCH and (
            degree == 1 << 13 or (degree == 1 << 12 and k <= 4)):
        return "per_prime"
    return "stacked"


def rns_poly_mult(a: torch.Tensor, b: torch.Tensor, rplan,
                  scheme: str = "exact") -> torch.Tensor:
    """The stacked product of (k, ..., N) blocks of one shape and device,
    row i under rplan.moduli[i] (`hexl_tpu/poly.py::_jitted_rns_poly_mult`):
    both forwards to [0, 4q) over the whole basis, K4.rows at IMF 4, the
    inverse to [0, q); on the GPU 2 x (1 or 2) + 1 + (1 or 2) launches for
    the basis, on the CPU the plain versions."""
    fa = rns.fwd_ntt_rns(a, rplan, 1, 4, scheme)
    fb = rns.fwd_ntt_rns(b, rplan, 1, 4, scheme)
    prod = ops.mult_mod_rows(fa, fb, rplan.moduli, 4)
    return rns.inv_ntt_rns(prod, rplan, 1, 1, scheme)


def _broadcast_rows(ta: torch.Tensor, tb: torch.Tensor, degree: int):
    """(k, ..., N) operands broadcast as each prime's rows broadcast in
    `_broadcast_polys` (their ranks equalised behind the prime axis)."""
    for t in (ta, tb):
        if t.shape[-1] != degree:
            raise ValueError(f"operands must have shape (..., {degree}), "
                             f"got {tuple(t.shape)}")
    rank = max(ta.dim(), tb.dim())
    ta, tb = (t.reshape(t.shape[0], *([1] * (rank - t.dim())), *t.shape[1:])
              for t in (ta, tb))
    return _device.broadcast((ta, tb))


def rns_poly_mult_mod(a, b, degree: int, moduli, device=None):
    """Per-prime negacyclic products: a, b shaped (num_primes, ..., N) with
    residues mod moduli[i] along the leading axis, in [0, moduli[i]);
    returns the same shape. Operands and devices as in `poly_mult_mod`;
    each prime's rows broadcast as there, as the JAX pipeline's do.

    As in the JAX package (poly.py:152-171), a basis of k > 1 distinct
    primes takes the stacked route (`rns_poly_mult`) where `rns_route`
    picks it, and otherwise, and for a repeated prime or k = 1,
    `poly_mult` per prime. Every output is fully reduced, so the routes
    give the same bits."""
    moduli = [int(q) for q in moduli]
    if degree < 2:
        raise ValueError("degree must be at least 2")
    (ta, tb), host = _device.operands((a, b), device)
    if any(t.dim() < 2 or t.shape[0] != len(moduli) for t in (ta, tb)):
        raise ValueError(
            f"operands must both have shape ({len(moduli)}, ..., {degree})")
    k = len(moduli)
    scheme = torch_ntt.scheme_for(max(moduli), degree, ta.device)
    if k > 1 and len(set(moduli)) == k:
        ta, tb = _broadcast_rows(ta, tb, degree)
        if rns_route(degree, k, ta[0].numel() // degree) == "stacked":
            out = rns_poly_mult(ta, tb, rns.get_rns_plan(degree, moduli),
                                scheme)
            return to_numpy(out) if host else out
    out = torch.stack([
        poly_mult(*_broadcast_polys(ta[i], tb[i], degree),
                  get_plan(degree, q), scheme)
        for i, q in enumerate(moduli)])
    return to_numpy(out) if host else out
