"""Plain PyTorch negacyclic NTT: the flat radix-2 exact-Harvey walk.

The counterpart of `hexl_tpu/ntt/jnp_ntt.py` fwd_ntt/inv_ntt with their flat
bodies fwd_body_small/inv_body_small, for every N from 2 to 2^14, on int64
tensors carrying u64 bits (see `..limb`). It runs on any device. The CUDA
kernels of `cuda_ntt` compute exactly this, lazy outputs included; the
wrappers there use it for tensors on the CPU, and `chip_smoke.py` holds the
kernels against it on the card.
"""

from __future__ import annotations

import torch

from ..limb import cond_sub64_half, reduce_mod_lazy64, s64, shoup_mul_lazy

FWD_IMF = (1, 2, 4)
FWD_OMF = (1, 4)
INV_IMF = (1, 2)
INV_OMF = (1, 2)


def check_factors(forward: bool, imf: int, omf: int) -> None:
    if forward:
        if imf not in FWD_IMF:
            raise ValueError("input_mod_factor must be 1, 2 or 4")
        if omf not in FWD_OMF:
            raise ValueError("output_mod_factor must be 1 or 4")
    else:
        if imf not in INV_IMF:
            raise ValueError("input_mod_factor must be 1 or 2")
        if omf not in INV_OMF:
            raise ValueError("output_mod_factor must be 1 or 2")


def _split(x: torch.Tensor, m: int, t: int):
    """(..., n) -> X and Y halves (..., m, t) of each block of 2t."""
    v = x.reshape(*x.shape[:-1], m, 2, t)
    return v[..., 0, :], v[..., 1, :]


def _join(nx: torch.Tensor, ny: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.stack((nx, ny), dim=-2)
    return out.reshape(*out.shape[:-3], n)


def fwd_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1) -> torch.Tensor:
    """Forward NTT of x (..., N), bit-reversed output.

    Input < IMF*q (IMF in {1,2,4}); output in [0,q) (OMF=1) or [0,4q)
    (OMF=4). Butterfly: X' = red2q(X) + T, Y' = red2q(X) + 2q - T with
    T = shoup(Y, W) in [0,2q)."""
    check_factors(True, input_mod_factor, output_mod_factor)
    tabs = plan.tables(x.device)
    rop, prop = tabs["rop"], tabs["prop"]
    n, q = plan.n, plan.q
    two_q = s64(2 * q)
    m = 1
    while m < n:
        t = n // (2 * m)
        xs, ys = _split(x, m, t)
        w = rop[m:2 * m, None]
        wp = prop[m:2 * m, None]
        tx = cond_sub64_half(xs, two_q)
        tt = shoup_mul_lazy(ys, w, wp, q)
        x = _join(tx + tt, tx + two_q - tt, n)
        m *= 2
    if output_mod_factor == 1:
        x = reduce_mod_lazy64(x, q, 4)
    return x


def inv_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1) -> torch.Tensor:
    """Inverse NTT from bit-reversed input (..., N).

    Input < IMF*q (IMF in {1,2}); output in [0,q) (OMF=1) or [0,2q)
    (OMF=2). The last stage is fused with the scale by N^-1."""
    check_factors(False, input_mod_factor, output_mod_factor)
    tabs = plan.tables(x.device)
    irop, pirop = tabs["irop"], tabs["pirop"]
    n, q = plan.n, plan.q
    two_q = s64(2 * q)
    root_index = 1
    t = 1
    while t < n // 2:
        m = n // (2 * t)
        xs, ys = _split(x, m, t)
        w = irop[root_index:root_index + m, None]
        wp = pirop[root_index:root_index + m, None]
        tx = cond_sub64_half(xs + ys, two_q)
        ty = xs + two_q - ys
        x = _join(tx, shoup_mul_lazy(ty, w, wp, q), n)
        root_index += m
        t *= 2
    xs, ys = _split(x, 1, n // 2)
    tx = cond_sub64_half(xs + ys, two_q)
    ty = xs + two_q - ys
    nx = shoup_mul_lazy(tx, s64(plan.inv_n), s64(plan.inv_n_precon), q)
    ny = shoup_mul_lazy(ty, s64(plan.inv_n_w), s64(plan.inv_n_w_precon), q)
    x = _join(nx, ny, n)
    if output_mod_factor == 1:
        x = cond_sub64_half(x, s64(q))
    return x
