"""Plain PyTorch negacyclic NTT: the flat radix-2 exact-Harvey walk.

The counterpart of `hexl_tpu/ntt/jnp_ntt.py` fwd_ntt/inv_ntt with their flat
bodies fwd_body_small/inv_body_small, for every N from 2 to 2^20, on int64
tensors carrying u64 bits (see `..limb`). It runs on any device. The CUDA
kernels compute exactly this, lazy outputs included; their wrappers use it
for tensors on the CPU, and `chip_smoke.py` holds the kernels against it on
the card.

The walk is written stage by stage (`fwd_stages`, `inv_stages`,
`inv_final`) so that the two-pass split of `hier` and the single-word
transform of `ntt32` run the same stages: `word=32` swaps in the Shoup
multiply of `ntt32.shoup32` and the twiddles preconditioned at 2^32, and
changes nothing else (every lazy value of the single-word regime is < 4q <
2^32, so the int64 halvers and sums are those of the 64-bit walk).
"""

from __future__ import annotations

import torch

from ..limb import MASK32, cond_sub64_half, reduce_mod_lazy64, s64, \
    shoup_mul_lazy

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


def mulhi32(a: torch.Tensor, b) -> torch.Tensor:
    """High 32 bits of the product of two u32 values held in int64: the
    wrapped int64 product has the right bits, `>>` copies the sign."""
    return ((a * b) >> 32) & MASK32


def shoup32(x: torch.Tensor, w, w_precon, modulus: int) -> torch.Tensor:
    """(x * w) mod q in [0, 2q) for q < 2^30 and any x < 2^32, with
    w_precon = floor(w << 32 / q); the difference is taken mod 2^32, as
    the u32 arithmetic of `hexl_tpu/ntt/ntt32.py::_shoup32` does."""
    return (x * w - mulhi32(x, w_precon) * modulus) & MASK32


def _shoup(word: int):
    return shoup32 if word == 32 else shoup_mul_lazy


def _split(x: torch.Tensor, m: int, t: int):
    """(..., n) -> X and Y halves (..., m, t) of each block of 2t."""
    v = x.reshape(*x.shape[:-1], m, 2, t)
    return v[..., 0, :], v[..., 1, :]


def _join(nx: torch.Tensor, ny: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.stack((nx, ny), dim=-2)
    return out.reshape(*out.shape[:-3], n)


def fwd_index(m: int, shard: int = 0, shards: int = 1) -> int:
    """Where block 0 of a forward stage with m blocks per shard starts in
    rop, for shard `shard` of `shards` contiguous shards: the global stage
    has m * shards blocks, starting at index m * shards."""
    return m * (shards + shard)


def fwd_stages(x: torch.Tensor, plan, m_first: int, m_stop: int,
               word: int = 64, shard: int = 0,
               shards: int = 1) -> torch.Tensor:
    """The forward stages with m_first <= m < m_stop blocks over x's last
    axis (stride t = n/(2m), n = x.shape[-1]); block k reads
    rop[fwd_index(m, shard, shards) + k]. With shards = 1, x (..., N) is
    the whole transform; with shards = D, x holds shard `shard` of the D
    contiguous shards of N/D coefficients and runs its stages of stride
    < N/D. Inputs [0, 4q) -> [0, 4q). Butterfly: X' = red2q(X) + T,
    Y' = red2q(X) + 2q - T with T = shoup(Y, W) in [0, 2q)."""
    rop, prop = plan.twiddles(x.device, True, word)
    shoup = _shoup(word)
    n, q = x.shape[-1], plan.q
    two_q = s64(2 * q)
    m = m_first
    while m < m_stop:
        first = fwd_index(m, shard, shards)
        xs, ys = _split(x, m, n // (2 * m))
        tx = cond_sub64_half(xs, two_q)
        tt = shoup(ys, rop[first:first + m, None], prop[first:first + m, None],
                   q)
        x = _join(tx + tt, tx + two_q - tt, n)
        m *= 2
    return x


def root_index(n: int, t: int) -> int:
    """Where the inverse stage of stride t starts in the stage-major irop:
    1 + the sum of N/(2t') over the strides t' < t."""
    index, s = 1, 1
    while s < t:
        index += n // (2 * s)
        s *= 2
    return index


def inv_index(n: int, m: int, shard: int = 0, shards: int = 1) -> int:
    """Where block 0 of an inverse stage with m blocks per shard starts in
    irop, for shard `shard` of `shards`: the global stage has m * shards
    blocks (stride N/(2 m shards))."""
    return root_index(n, n // (2 * m * shards)) + shard * m


def inv_stages(x: torch.Tensor, plan, t_first: int, t_stop: int,
               word: int = 64, shard: int = 0,
               shards: int = 1) -> torch.Tensor:
    """The inverse stages of stride t_first <= t < t_stop over x's last
    axis (m = n/(2t) blocks, n = x.shape[-1]); block k reads
    irop[inv_index(N, m, shard, shards) + k]. x and the shards as in
    `fwd_stages`; for the whole transform t_stop <= N/2, the last stage
    being `inv_final`. Inputs [0, 2q) -> [0, 2q)."""
    irop, pirop = plan.twiddles(x.device, False, word)
    shoup = _shoup(word)
    n, q = x.shape[-1], plan.q
    two_q = s64(2 * q)
    t = t_first
    while t < t_stop:
        m = n // (2 * t)
        index = inv_index(plan.n, m, shard, shards)
        xs, ys = _split(x, m, t)
        tx = cond_sub64_half(xs + ys, two_q)
        ty = xs + two_q - ys
        x = _join(tx, shoup(ty, irop[index:index + m, None],
                            pirop[index:index + m, None], q), n)
        t *= 2
    return x


def inv_final(x: torch.Tensor, plan, omf: int,
              word: int = 64) -> torch.Tensor:
    """The last inverse stage (stride N/2, pairing the halves of x's last
    axis) fused with the scale by N^-1: outputs [0, 2q), or [0, q) for
    OMF 1."""
    shoup = _shoup(word)
    n, q = x.shape[-1], plan.q
    two_q = s64(2 * q)
    inv_n, inv_n_precon, inv_n_w, inv_n_w_precon = plan.fin(word)
    xs, ys = _split(x, 1, n // 2)
    tx = cond_sub64_half(xs + ys, two_q)
    ty = xs + two_q - ys
    nx = shoup(tx, inv_n, s64(inv_n_precon), q)
    ny = shoup(ty, inv_n_w, s64(inv_n_w_precon), q)
    x = _join(nx, ny, n)
    if omf == 1:
        x = cond_sub64_half(x, s64(q))
    return x


def fwd_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1, word: int = 64) -> torch.Tensor:
    """Forward NTT of x (..., N), bit-reversed output.

    Input < IMF*q (IMF in {1,2,4}); output in [0,q) (OMF=1) or [0,4q)
    (OMF=4)."""
    check_factors(True, input_mod_factor, output_mod_factor)
    x = fwd_stages(x, plan, 1, plan.n, word)
    if output_mod_factor == 1:
        x = reduce_mod_lazy64(x, plan.q, 4)
    return x


def inv_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1, word: int = 64) -> torch.Tensor:
    """Inverse NTT from bit-reversed input (..., N).

    Input < IMF*q (IMF in {1,2}); output in [0,q) (OMF=1) or [0,2q)
    (OMF=2). The last stage is fused with the scale by N^-1."""
    check_factors(False, input_mod_factor, output_mod_factor)
    x = inv_stages(x, plan, 1, plan.n // 2, word)
    return inv_final(x, plan, output_mod_factor, word)
