"""Plain PyTorch negacyclic NTT: the flat radix-2 walk, exact or lean.

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

`scheme` picks the butterflies of the 64-bit walk, as `jnp_ntt._bflys3`
does for the JAX engine's device bodies: "exact" (Harvey with the exact
Shoup quotient, the JAX CPU bodies), or one of the approximate-quotient
schemes of `config.approx_butterflies` (quotient `mulhi64_approx6`, up to 6
too small): "lean16" (q < 2^60, N >= 2^13: forward invariant [0, 16q),
inverse [0, 8q), one halver per butterfly) or "lean8" (q < 2^61: forward
[0, 8q), inverse [0, 4q), two halvers). A lean forward ends with
`fwd_fixup` back to [0, 4q), a lean inverse with its own final stage, so
the contracts of both directions hold; lazy values differ from the exact
walk's, fully reduced ones do not. The fourth scheme, "approx", is the
pair the JAX package's Pallas kernels run for every q < 2^61
(`pallas_ntt._butterflies`: `jnp_ntt._fwd_butterfly_approx`,
`_inv_butterfly_approx`, `_shoup_approx`): the same quotient on Harvey's
invariants (forward [0, 4q), inverse [0, 2q)), the raw product in [0, 8q)
halved at 4q and then at 2q, no fixup, and the exact final stage. The
single-word walk has no approximate form.
"""

from __future__ import annotations

import torch

from .. import config
from ..limb import MASK32, cond_sub64_half, mulhi64_approx6, \
    reduce_mod_lazy64, s64, shoup_mul_lazy

# Largest modulus of the lean schemes (their raw product lies in [0, 8q));
# largest of lean16 (its forward invariant is [0, 16q)); smallest degree
# that takes lean16: `hexl_tpu/ntt/jnp_ntt.py:31-47`.
LEAN_APPROX_MAX_Q = 1 << 61
LEAN16_MAX_Q = 1 << 60
LEAN16_MIN_N = 1 << 13
SCHEMES = ("exact", "lean16", "lean8", "approx")
# Each scheme's code in the kernels' C entries (csrc/modarith.cuh Scheme).
SCHEME_CODE = {"exact": 0, "lean16": 1, "lean8": 2, "approx": 3}
# The additive constant of each scheme's invariant: the halvers' bound and
# what Y' = X + C - T adds, in both directions.
_WIDE = {"exact": 2, "lean16": 8, "lean8": 4, "approx": 2}
# The schemes on Harvey's invariants: no forward fixup, the exact final
# stage.
HARVEY = ("exact", "approx")


def scheme_gates(q_max: int, n: int) -> tuple:
    """(lean_ok, lean16_ok) for a degree-n transform whose largest modulus
    is q_max, as `jnp_ntt.scheme_gates`."""
    return (q_max < LEAN_APPROX_MAX_Q,
            q_max < LEAN16_MAX_Q and n >= LEAN16_MIN_N)


def scheme_of(lean_ok: bool, lean16_ok: bool) -> str:
    """The scheme `jnp_ntt._bflys3` picks with approximation on. ("approx",
    the Pallas kernels' form, is reached through the kernel wrappers'
    `scheme` argument only, as the JAX package reaches it through its
    Pallas backend.)"""
    if lean16_ok:
        return "lean16"
    return "lean8" if lean_ok else "exact"


def scheme_for(q_max: int, n: int, device) -> str:
    """The scheme of a 64-bit transform of degree n whose largest modulus
    is q_max, on `device`: exact unless `config.approx_butterflies`."""
    if not config.approx_butterflies(device):
        return "exact"
    return scheme_of(*scheme_gates(q_max, n))


def check_scheme(scheme: str, q: int, word: int = 64) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if scheme != "exact" and word != 64:
        raise ValueError("the single-word walk has no approximate scheme")
    if scheme in ("lean8", "approx") and q >= LEAN_APPROX_MAX_Q:
        raise ValueError(f"{scheme} needs q < 2^61")
    if scheme == "lean16" and q >= LEAN16_MAX_Q:
        raise ValueError("lean16 needs q < 2^60")


def check_harvey(scheme: str, q: int, what: str) -> None:
    """`what` runs the schemes on Harvey's invariants only: "exact", or
    "approx" (q < 2^61)."""
    if scheme not in HARVEY:
        raise ValueError(f"{what} runs {HARVEY}, got {scheme!r}")
    check_scheme(scheme, q)


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


def shoup_approx(x: torch.Tensor, w, w_precon, modulus: int) -> torch.Tensor:
    """x * w - q_hat * q with the approximate quotient: [0, 8q) for any
    64-bit x (q < 2^61)."""
    return x * w - mulhi64_approx6(x, w_precon) * s64(modulus)


def shoup_approx_harvey(x: torch.Tensor, w, w_precon,
                        modulus: int) -> torch.Tensor:
    """`shoup_approx` halved at 4q and then at 2q: [0, 2q), as
    `jnp_ntt._shoup_approx`."""
    r = cond_sub64_half(shoup_approx(x, w, w_precon, modulus),
                        s64(4 * modulus))
    return cond_sub64_half(r, s64(2 * modulus))


def _product(scheme: str, word: int):
    """The butterflies' twiddle product: [0, 2q) exact and approx, [0, 8q)
    lean16, [0, 4q) lean8 (the raw product halved once)."""
    if scheme == "exact":
        return _shoup(word)
    if scheme == "lean16":
        return shoup_approx
    if scheme == "approx":
        return shoup_approx_harvey
    return lambda x, w, wp, q: cond_sub64_half(shoup_approx(x, w, wp, q),
                                               s64(4 * q))


def fwd_butterfly(xs: torch.Tensor, ys: torch.Tensor, w, wp, q: int,
                  scheme: str = "exact", word: int = 64) -> tuple:
    """X' = red(X) + T, Y' = red(X) + C - T with C = 2q (exact, approx),
    8q (lean16) or 4q (lean8) and T the scheme's product of Y and W:
    `jnp_ntt._fwd_butterfly`, `_fwd_butterfly_lean16`, `_lean8`,
    `_approx`. Inputs [0, 2C) -> outputs [0, 2C)."""
    wide = s64(_WIDE[scheme] * q)
    tx = cond_sub64_half(xs, wide)
    tt = _product(scheme, word)(ys, w, wp, q)
    return tx + tt, tx + wide - tt


def inv_butterfly(xs: torch.Tensor, ys: torch.Tensor, w, wp, q: int,
                  scheme: str = "exact", word: int = 64) -> tuple:
    """X' = red(X + Y), Y' = (X + C - Y) W: `jnp_ntt._inv_butterfly`,
    `_inv_butterfly_lean8` (lean16's), `_lean4` (lean8's), `_approx`.
    Inputs [0, C) -> outputs [0, C)."""
    wide = s64(_WIDE[scheme] * q)
    tx = cond_sub64_half(xs + ys, wide)
    return tx, _product(scheme, word)(xs + wide - ys, w, wp, q)


def fwd_fixup(x: torch.Tensor, q: int, scheme: str) -> torch.Tensor:
    """A lean forward's output back to the OMF 4 contract [0, 4q):
    `jnp_ntt._fwd_fixup`."""
    if scheme == "lean16":
        x = cond_sub64_half(x, s64(8 * q))
    if scheme not in HARVEY:
        x = cond_sub64_half(x, s64(4 * q))
    return x


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
               word: int = 64, shard: int = 0, shards: int = 1,
               scheme: str = "exact") -> torch.Tensor:
    """The forward stages with m_first <= m < m_stop blocks over x's last
    axis (stride t = n/(2m), n = x.shape[-1]); block k reads
    rop[fwd_index(m, shard, shards) + k]. With shards = 1, x (..., N) is
    the whole transform; with shards = D, x holds shard `shard` of the D
    contiguous shards of N/D coefficients and runs its stages of stride
    < N/D. Butterflies: `fwd_butterfly` of `scheme`; exact inputs
    [0, 4q) -> [0, 4q)."""
    check_scheme(scheme, plan.q, word)
    rop, prop = plan.twiddles(x.device, True, word)
    n = x.shape[-1]
    m = m_first
    while m < m_stop:
        first = fwd_index(m, shard, shards)
        xs, ys = _split(x, m, n // (2 * m))
        x = _join(*fwd_butterfly(xs, ys, rop[first:first + m, None],
                                 prop[first:first + m, None], plan.q, scheme,
                                 word), n)
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
               word: int = 64, shard: int = 0, shards: int = 1,
               scheme: str = "exact") -> torch.Tensor:
    """The inverse stages of stride t_first <= t < t_stop over x's last
    axis (m = n/(2t) blocks, n = x.shape[-1]); block k reads
    irop[inv_index(N, m, shard, shards) + k]. x and the shards as in
    `fwd_stages`; for the whole transform t_stop <= N/2, the last stage
    being `inv_final`. Butterflies: `inv_butterfly` of `scheme`; exact
    inputs [0, 2q) -> [0, 2q)."""
    check_scheme(scheme, plan.q, word)
    irop, pirop = plan.twiddles(x.device, False, word)
    n = x.shape[-1]
    t = t_first
    while t < t_stop:
        m = n // (2 * t)
        index = inv_index(plan.n, m, shard, shards)
        xs, ys = _split(x, m, t)
        x = _join(*inv_butterfly(xs, ys, irop[index:index + m, None],
                                 pirop[index:index + m, None], plan.q, scheme,
                                 word), n)
        t *= 2
    return x


def inv_final(x: torch.Tensor, plan, omf: int, word: int = 64,
              scheme: str = "exact") -> torch.Tensor:
    """The last inverse stage (stride N/2, pairing the halves of x's last
    axis) fused with the scale by N^-1: outputs [0, 2q), or [0, q) for
    OMF 1. A lean scheme's inputs lie in [0, C) (C = 8q or 4q) and need no
    halver, the exact Shoup product taking any 64-bit value:
    `jnp_ntt._final_inv_stage_lean8` (lean16's), `_lean4` (lean8's);
    approx runs the exact stage (`_final_inv_stage`, as the Pallas kernels
    do)."""
    check_scheme(scheme, plan.q, word)
    shoup = _shoup(word)
    n, q = x.shape[-1], plan.q
    wide = s64(_WIDE[scheme] * q)
    inv_n, inv_n_precon, inv_n_w, inv_n_w_precon = plan.fin(word)
    xs, ys = _split(x, 1, n // 2)
    tx = xs + ys
    if scheme in HARVEY:
        tx = cond_sub64_half(tx, wide)
    ty = xs + wide - ys
    nx = shoup(tx, inv_n, s64(inv_n_precon), q)
    ny = shoup(ty, inv_n_w, s64(inv_n_w_precon), q)
    x = _join(nx, ny, n)
    if omf == 1:
        x = cond_sub64_half(x, s64(q))
    return x


def fwd_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1, word: int = 64,
            scheme: str = "exact") -> torch.Tensor:
    """Forward NTT of x (..., N), bit-reversed output.

    Input < IMF*q (IMF in {1,2,4}); output in [0,q) (OMF=1) or [0,4q)
    (OMF=4)."""
    check_factors(True, input_mod_factor, output_mod_factor)
    x = fwd_stages(x, plan, 1, plan.n, word, scheme=scheme)
    x = fwd_fixup(x, plan.q, scheme)
    if output_mod_factor == 1:
        x = reduce_mod_lazy64(x, plan.q, 4)
    return x


def inv_ntt(x: torch.Tensor, plan, input_mod_factor: int = 1,
            output_mod_factor: int = 1, word: int = 64,
            scheme: str = "exact") -> torch.Tensor:
    """Inverse NTT from bit-reversed input (..., N).

    Input < IMF*q (IMF in {1,2}); output in [0,q) (OMF=1) or [0,2q)
    (OMF=2). The last stage is fused with the scale by N^-1."""
    check_factors(False, input_mod_factor, output_mod_factor)
    x = inv_stages(x, plan, 1, plan.n // 2, word, scheme=scheme)
    return inv_final(x, plan, output_mod_factor, word, scheme)
