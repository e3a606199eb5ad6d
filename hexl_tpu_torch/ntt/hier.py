"""The NTT above 2^14: the two-pass split and the wrappers of K5 and K6.

The counterpart of `hexl_tpu/ntt/hier.py`. A transform of degree
N = D * 2^14 (D = 2 .. 64) is viewed as D contiguous shards of
LOCAL_N = 2^14 coefficients. The stages of stride >= LOCAL_N pair equal
offsets of two shards (the cross pass); the others stay within a shard
(the local pass). The forward runs cross then local, with the OMF
reduction in the local pass; the inverse runs local then cross, with the
global final stage x N^-1 and the OMF reduction in the cross pass
(hier.py:293-316).

The plain versions are the flat walk of `torch_ntt` cut at stride LOCAL_N,
so the split is bit-identical to the flat walk, lazy outputs included.
On the GPU the cross pass is K5 (`csrc/ntt_hier.cu`, replacing
hier.py::_cross_call) and the local pass K6 (the kernels of
`csrc/ntt_block.cuh` with one shard per CTA, replacing ::_local_call). Both
read the plan's flat tables, a shard at its offset in them. `word` is 64,
or 32 for the single-word regime of q < 2^30 (`ntt32`), which runs the
u32 instantiation of both kernels. K5 has two forms, both hand-written
kernels chosen by `cross_form` from the shape, word and scheme: a thread a
column ("column"), or tiles walked by persistent CTAs through shared
memory ("tile", `csrc/cross_tile.cuh`), taken where the column form stays
under half of its bound on the card. Launches are counted in
`_build.launches` under "K5"/"K5.tile"/"K6", or "K5.u32"/"K6.u32" (and
the lean instantiations under "K5.lean16" ...). Where K6's grid is under
a wave, the local pass of a 64-bit exact transform runs the stacked
cluster form over a one-row basis of its prime ("K6.rns.cl",
`rns.cluster_transform`). `cross` takes
any (..., D, w) block, the split's view of the whole transform or the
exchanged block of a DistNTT position; `local_launch` takes the shard base
that a position's local pass (`shard`) passes. `scheme` (word 64) picks
the butterflies of both passes (`torch_ntt`): a lean forward's fixup runs
at the end of the local pass, a lean inverse's final stage in the cross
pass; "approx" (the JAX Pallas kernels' form) keeps Harvey's invariants
and the exact final stage. The parallel layer's cross pass stays exact;
a position's local pass runs "exact" or "approx" (`shard`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, nt
from ..limb import reduce_mod_lazy64
from . import torch_ntt

LOG_LOCAL = 14
LOCAL_N = 1 << LOG_LOCAL

_P = ctypes.c_void_p
_U = ctypes.c_uint64
_I = ctypes.c_int
_CROSS_FWD_ARGS = (_P, _P, _P, _P, _U, _I, _I, _I, _I, _I, _I, _P)
_CROSS_INV_ARGS = (_P, _P, _P, _P, _U, _U, _U, _U, _U, _I, _I, _I, _I, _I,
                   _I, _I, _I, _P)
_LOCAL_FWD_ARGS = (_P, _P, _P, _P, _U, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_LOCAL_INV_ARGS = (_P, _P, _P, _P, _U, _I, _I, _I, _I, _I, _I, _I, _P)
MAX_CROSS_ROWS = 64    # K5 takes at most 64 rows a launch

# K5's two forms (csrc/ntt_hier.cu) and their launch names: "column", a
# thread a column with its D coefficients in registers, and "tile"
# (csrc/cross_tile.cuh), persistent CTAs walking tiles of D rows x
# TILE_COEFFS / D columns through a ring of shared-memory buffers filled
# by cp.async, the stages run as radix passes of up to three. TILE_COEFFS
# is the source's.
CROSS_FORMS = {"column": "K5", "tile": "K5.tile"}
TILE_COEFFS = 1024


def shards(plan) -> int:
    """D, the number of LOCAL_N shards of a transform of the plan's N."""
    if plan.n <= LOCAL_N:
        raise ValueError(f"the two-pass split needs N > 2^14, got {plan.n}")
    return plan.n // LOCAL_N


def tile_columns(log_d: int) -> int:
    """C, the columns of a tile of the tiled form at D = 2^log_d."""
    return TILE_COEFFS >> log_d


def cross_forms(log_d: int, log_lc: int, aligned: bool = True) -> list:
    """The forms K5 takes on (2^log_d, 2^log_lc) blocks: the column form
    always; the tiled form where a row holds a tile's columns and the
    block starts on 16 bytes (its copies are 16 bytes wide)."""
    forms = ["column"]
    if aligned and 1 << log_lc >= tile_columns(log_d):
        forms.append("tile")
    return forms


def cross_form(log_d: int, log_lc: int, batch: int, word: int = 64,
               scheme: str = "exact", aligned: bool = True) -> str:
    """K5's form for `batch` blocks of (2^log_d, 2^log_lc) in `word` and
    `scheme`, among `cross_forms`: the tiled form at D = 64 in u64, the
    one count of rows at which the column form stays under half of its
    bytes bound (36-37%, against 58-76% at D = 2 .. 32 in u64 and 65-79%
    at every D in u32), and where the tiled form reaches 54-55%; the
    column form elsewhere (`chip_smoke.py --k5-times` on one H100 80GB
    HBM3 at 700 W; PERF.md row 5)."""
    if log_d == 6 and word == 64 and \
            "tile" in cross_forms(log_d, log_lc, aligned):
        return "tile"
    return "column"


def kernel_name(kernel: str, word: int, scheme: str = "exact") -> str:
    """The launch name: "K5", "K5.u32" (word 32), "K5.lean16" ..."""
    if word == 32:
        return f"{kernel}.u32"
    return kernel if scheme == "exact" else f"{kernel}.{scheme}"


# -- plain versions: the flat walk cut at stride LOCAL_N --------------------

def cross_fwd_plain(x: torch.Tensor, plan, word: int = 64,
                    scheme: str = "exact") -> torch.Tensor:
    """The forward stages of stride >= N/D on a (..., D, w) block (its
    rows at stride N/D, its columns adjacent): flattened, the flat walk's
    first log2(D) stages, each pair of rows at the twiddle of the whole
    transform."""
    flat = x.reshape(*x.shape[:-2], -1)
    return torch_ntt.fwd_stages(flat, plan, 1, x.shape[-2], word,
                                scheme=scheme).reshape(x.shape)


def local_fwd_plain(x: torch.Tensor, plan, omf: int, word: int = 64,
                    scheme: str = "exact") -> torch.Tensor:
    """The forward stages of stride < LOCAL_N, then a lean scheme's fixup
    and the OMF reduction."""
    x = torch_ntt.fwd_stages(x, plan, shards(plan), plan.n, word,
                             scheme=scheme)
    x = torch_ntt.fwd_fixup(x, plan.q, scheme)
    if omf == 1:
        x = reduce_mod_lazy64(x, plan.q, 4)
    return x


def local_inv_plain(x: torch.Tensor, plan, word: int = 64,
                    scheme: str = "exact") -> torch.Tensor:
    """The inverse stages of stride < LOCAL_N."""
    shards(plan)
    return torch_ntt.inv_stages(x, plan, 1, LOCAL_N, word, scheme=scheme)


def cross_inv_plain(x: torch.Tensor, plan, omf: int, word: int = 64,
                    scheme: str = "exact") -> torch.Tensor:
    """The inverse stages of stride >= N/D on a (..., D, w) block, the last
    fused with N^-1, then the OMF reduction."""
    flat = x.reshape(*x.shape[:-2], -1)
    flat = torch_ntt.inv_stages(flat, plan, x.shape[-1], flat.shape[-1] // 2,
                                word, scheme=scheme)
    return torch_ntt.inv_final(flat, plan, omf, word,
                               scheme).reshape(x.shape)


def local_launch_plain(x: torch.Tensor, plan, forward: bool, omf: int,
                       log_n: int, log_d: int, shard_base: int, log_sub: int,
                       word: int = 64, scheme: str = "exact") -> torch.Tensor:
    """The plain version of `local_launch`: the stages of stride < 2^log_n
    of chunk c as shard shard_base + (c mod 2^log_sub) of 2^log_d, the
    forward then a lean scheme's fixup and the OMF reduction."""
    n, shards, period = 1 << log_n, 1 << log_d, 1 << log_sub
    flat = x.reshape(-1, n)
    out = torch.empty_like(flat)
    for r in range(period):
        v, shard = flat[r::period], shard_base + r
        if forward:
            v = torch_ntt.fwd_stages(v, plan, 1, n, word, shard, shards,
                                     scheme)
            v = torch_ntt.fwd_fixup(v, plan.q, scheme)
            if omf == 1:
                v = reduce_mod_lazy64(v, plan.q, 4)
        else:
            v = torch_ntt.inv_stages(v, plan, 1, n, word, shard, shards,
                                     scheme)
        out[r::period] = v
    return out.reshape(x.shape)


# -- the launches of K5 and K6 ----------------------------------------------

def cross_launch(x: torch.Tensor, w: torch.Tensor, wp: torch.Tensor, plan,
                 log_d: int, log_lc: int, forward: bool, omf: int = 1,
                 final_stage: bool = True, word: int = 64,
                 log_groups: int = 0, scheme: str = "exact") -> torch.Tensor:
    """K5 on the (..., 2^log_d, 2^log_lc) blocks of x, a CUDA tensor: the
    forward stages m = 1 .. D/2 with block k of stage m at w[m + k], or
    the inverse stages with block k of the stage of m blocks at
    w[D - 2m + k], ending with the global final stage x N^-1 and the OMF
    (final_stage) or with an ordinary stage at w[D - 2]. With G =
    2^log_groups, block b of x is group g = b mod G of G consecutive
    blocks, the rows of one block of G D rows, and reads the twiddles of
    that block's stages: forward w[m (G + g) + k], inverse
    w[G (D - 2m) + g m + k] (no final stage). `scheme` picks the
    butterflies (word 64 only). The form is `cross_form`'s; one the blocks
    do not take (`cross_forms`) raises."""
    if not 2 <= 1 << log_d <= MAX_CROSS_ROWS:
        raise ValueError(f"K5 takes 2 to {MAX_CROSS_ROWS} rows, got "
                         f"{1 << log_d}")
    out = torch.empty_like(x)
    batch = _build.batch_of(x, 1 << (log_d + log_lc))
    if batch == 0:
        return out
    aligned = x.data_ptr() % 16 == 0
    form = cross_form(log_d, log_lc, batch, word, scheme, aligned)
    if form not in cross_forms(log_d, log_lc, aligned):
        raise ValueError(f"K5's {form} form does not take blocks of "
                         f"({1 << log_d}, {1 << log_lc})")
    name = kernel_name(CROSS_FORMS[form], word, scheme)
    entry = "hexl_cross_tile" if form == "tile" else "hexl_cross"
    if forward:
        fn = _build.function("ntt_hier", entry + "_fwd", _CROSS_FWD_ARGS)
        _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                         w.data_ptr(), wp.data_ptr(), plan.q, log_d, log_lc,
                         log_groups, batch, word,
                         torch_ntt.SCHEME_CODE[scheme])
    else:
        fn = _build.function("ntt_hier", entry + "_inv", _CROSS_INV_ARGS)
        _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                         w.data_ptr(), wp.data_ptr(), plan.q, *plan.fin(word),
                         log_d, log_lc, log_groups, batch, omf,
                         int(final_stage), word,
                         torch_ntt.SCHEME_CODE[scheme])
    return out


def cross_occupancy(log_d: int, forward: bool, word: int, device,
                    form: str = "column") -> int:
    """How many CTAs of K5's forward or final inverse kernel in `form` at
    D = 2^log_d (exact scheme) an SM of the card holds."""
    count = ctypes.c_int(0)
    fn = _build.function("ntt_hier", "hexl_cross_occupancy",
                         (_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)))
    with torch.cuda.device(device):
        err = fn(list(CROSS_FORMS).index(form), log_d, int(forward), word,
                 ctypes.byref(count))
    if err:
        raise RuntimeError(f"hexl_tpu_torch: the K5 occupancy query failed "
                           f"with cudaError {err}")
    return count.value


def local_launch(x: torch.Tensor, plan, forward: bool, omf: int, log_n: int,
                 log_d: int, shard_base: int, log_sub: int, word: int = 64,
                 scheme: str = "exact") -> torch.Tensor:
    """K6 on the 2^log_n-coefficient chunks of x, a CUDA tensor: chunk c is
    shard shard_base + (c mod 2^log_sub) of a transform of degree
    2^(log_n + log_d). The inverse ignores omf."""
    out = torch.empty_like(x)
    chunks = _build.batch_of(x, 1 << log_n)
    if chunks == 0:
        return out
    name = kernel_name("K6", word, scheme)
    w, wp = plan.twiddles(x.device, forward, word)
    if forward:
        fn = _build.function("ntt_hier", "hexl_local_fwd", _LOCAL_FWD_ARGS)
        _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                         w.data_ptr(), wp.data_ptr(), plan.q, log_n, log_d,
                         shard_base, log_sub, chunks, omf, word,
                         torch_ntt.SCHEME_CODE[scheme])
    else:
        fn = _build.function("ntt_hier", "hexl_local_inv", _LOCAL_INV_ARGS)
        _build.launch_on(x.device, name, fn, x.data_ptr(), out.data_ptr(),
                         w.data_ptr(), wp.data_ptr(), plan.q, log_n, log_d,
                         shard_base, log_sub, chunks, word,
                         torch_ntt.SCHEME_CODE[scheme])
    return out


# -- the kernel wrappers -----------------------------------------------------

def _cross_table(plan, device, forward: bool, word: int, rows: int):
    """K5's twiddles for the cross stages of `rows` rows of stride N/rows:
    the forward table whole, the inverse one from its stage of that
    stride on (taken from the rows: a block may be a slice of the
    columns, so its width says nothing of the stride)."""
    w, wp = plan.twiddles(device, forward, word)
    if forward:
        return w, wp
    start = torch_ntt.root_index(plan.n, plan.n // rows)
    return w[start:], wp[start:]


def cross_launches(log_d: int, log_w: int) -> list:
    """K5's launches on a (..., 2^log_d, 2^log_w) block, in the forward's
    order (the inverse runs them backwards), as (log_rows, log_lc,
    log_groups, log_table_rows): the stages of rows at stride lc, in
    groups of 2^log_groups consecutive blocks, with the twiddles of the
    cross stages of 2^log_table_rows rows. K5 takes at most
    MAX_CROSS_ROWS rows a launch; more, D = A B, run as two: the stages
    that pair rows of different groups of B consecutive rows (on the
    (..., A, B w) view) and those within a group (on the (..., A, B, w)
    view, each group with its own twiddles)."""
    log_a = log_d if 1 << log_d <= MAX_CROSS_ROWS else log_d // 2
    log_b = log_d - log_a
    launches = [(log_a, log_b + log_w, 0, log_a)]
    if log_b:
        launches.append((log_b, log_w, log_a, log_d))
    return launches


def cross(x: torch.Tensor, plan, forward: bool, omf: int = 1,
          word: int = 64, scheme: str = "exact") -> torch.Tensor:
    """The cross pass of a (..., D, w) block: K5 with column stride w on
    the GPU (`cross_launches`; the inverse ends with the global final
    stage in the launch of one group), the plain version on the CPU. The
    split passes the whole transform as (..., N/LOCAL_N, LOCAL_N); a
    DistNTT position its exchanged (..., D, L/D) block, or a slice of its
    columns. The forward ignores omf."""
    torch_ntt.check_scheme(scheme, plan.q, word)
    if not _build.on_card(x):
        if forward:
            return cross_fwd_plain(x, plan, word, scheme)
        return cross_inv_plain(x, plan, omf, word, scheme)
    launches = cross_launches(nt.log2_exact(x.shape[-2]),
                              nt.log2_exact(x.shape[-1]))
    for log_rows, log_lc, log_groups, log_table in (
            launches if forward else launches[::-1]):
        x = cross_launch(
            x, *_cross_table(plan, x.device, forward, word, 1 << log_table),
            plan, log_rows, log_lc, forward, omf, log_groups == 0, word,
            log_groups, scheme)
    return x


def local(x: torch.Tensor, plan, forward: bool, omf: int = 1,
          word: int = 64, scheme: str = "exact") -> torch.Tensor:
    """The local pass of x (..., N): K6 on the GPU, the plain version on
    the CPU. The inverse ignores omf."""
    log_d = nt.log2_exact(shards(plan))
    torch_ntt.check_scheme(scheme, plan.q, word)
    card = _build.on_card(x)
    if word == 64 and scheme == "exact":
        from . import rns   # rns imports this module
        routed = rns.cluster_transform(x, plan, forward, omf,
                                       _build.batch_of(x, plan.n))
        if routed is not None:
            return routed
    if not card:
        if forward:
            return local_fwd_plain(x, plan, omf, word, scheme)
        return local_inv_plain(x, plan, word, scheme)
    return local_launch(x, plan, forward, omf, LOG_LOCAL, log_d, 0, log_d,
                        word, scheme)


def _blocks(x: torch.Tensor, plan) -> torch.Tensor:
    """x (..., N) as the cross pass's (..., D, LOCAL_N) block."""
    return x.reshape(*x.shape[:-1], shards(plan), LOCAL_N)


def fwd_ntt(x: torch.Tensor, plan, omf: int = 1, word: int = 64,
            scheme: str = "exact") -> torch.Tensor:
    """Forward NTT of x (..., N), N > 2^14: cross pass, then local pass."""
    c = cross(_blocks(x, plan), plan, True, omf, word,
              scheme).reshape(x.shape)
    return local(c, plan, True, omf, word, scheme)


def inv_ntt(x: torch.Tensor, plan, omf: int = 1, word: int = 64,
            scheme: str = "exact") -> torch.Tensor:
    """Inverse NTT of x (..., N), N > 2^14: local pass, then cross pass."""
    loc = local(x, plan, False, omf, word, scheme)
    return cross(_blocks(loc, plan), plan, False, omf, word,
                 scheme).reshape(x.shape)
