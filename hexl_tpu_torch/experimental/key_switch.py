"""CKKS key switch, and the wrappers of kernels K10 and K11
(`csrc/key_switch.cu`).

The counterpart of `hexl_tpu/experimental/key_switch.py::key_switch`, with
its lazy ranges chained identically: the (2,1) inverse NTTs of the target
feed the base conversion (reduce_mod at IMF = q), the (4,4) forward NTTs
feed the 128-bit multiply-accumulate with the keys and its exact
Barrett-128 flush (K10), the key prime's (2,2) inverse feeds the +qk/2
spread (K11), and after the mod-down's (4,4) forward NTTs the fold
(K11) computes add_mod(result, fma_mod(..., IMF 8)). The transforms always
take the 64-bit walk, as the JAX function's do (it calls the 64-bit bodies
and the RNS transforms directly, never the public engine's single-word
route): `cuda_ntt` with word 64, K1/K2 up to 2^14 and K5/K6 above.

`switch` has one flow. The target's inverses give one stacked value; the
key prime's row is every target base-converted to qk and forward-
transformed, one batched call; the block (ds, ds - 1, n) holds in row i
the other targets base-converted to q_i and forward-transformed; and the
multiply-accumulate reads the block, the target (its own row's term, in
NTT form) and the key prime's row as three parts where they lie
(`mac_flush_parts`: one K10 launch, no assembled copy). Where the ds > 1
decomposition primes are distinct, the transforms that differ only in the
prime run stacked over them, as the JAX function runs them
(key_switch.py:105-160, `ntt.rns`: K1.rns/K2.rns, or K5.rns and K6.rns),
and the block is made by the route `block_route` names: above 2^14
("fused") K5.rns.conv loads each row's other targets from the inverses'
output, reduces them mod q_i and runs the cross pass
(`rns.fwd_ntt_rns_conv`); elsewhere ("staged") the other targets are
gathered (`others`) and reduced in one K8.reduce.rows launch, row i mod
q_i, before the stacked forward. Otherwise (ds = 1 or a repeated prime)
each transform is a call a prime and row i of the block one K8 reduction
of the other targets' stack; at ds = 1 the block is empty. A value below
q_i, which the JAX function leaves alone, is left alone by the reduction
too.

A tensor on the GPU goes to the kernels; a tensor on the CPU to the plain
versions (`mac_flush_parts_plain`, `spread_plain`, `fold_plain`, and the
plain NTT walk and eltwise bodies under the wrappers). `key_switch_plain`
runs the whole pipeline on the plain versions on any device. Every output
is fully reduced, so each equals the JAX package's bit for bit. Launches
are counted under "K10" and "K11" (and those of the NTTs and of K8 under
theirs).

Where `config.approx_butterflies` is on for the operands' device, the
steps take the approximate quotients the JAX function takes where its
switch is on (`jnp_kernels._approx()`): the base conversion's and the
spread's reductions, the spread's +qk/2 Barrett (key_switch.py:236-247),
the fold's Shoup product of fma_mod at IMF 8 (:281-282) and, by the JAX
function's own rule (`pipeline`), the flush of the multiply-accumulate
(`_barrett_reduce_128`, :34-51): the kernels' instantiations on them
(launch names "K10.approx", "K11.approx", "K8.reduce.rows.approx" ...) or
the plain versions with `approx=True`. The transforms stay exact. Every
output is fully reduced, so the bits are the same either way.

On the card the chain before the fold is replayed from a CUDA graph
(`run`). `switch` (every step up to the mod-down's forward NTTs: 13
launches on the fused route; 14 and the aten gather of `others` on the
staged one) does the same thing on every call of one key (`graph_key`,
which holds the route rules in force, so that a rule forced in a test or
a timing gets a graph of its own). A key's first call runs eagerly, which
fills every cache the chain reads (plans, descriptors, constants, row
constants, `_others_index`, the occupancy queries), so that nothing is
copied from the host or queried inside a capture; its second captures
`switch` on a static copy of t_target into a graph with its own memory
pool (`capture`); every later call copies t_target into the graph's input
and replays it (`graph`). The fold (K11) is launched eagerly every time,
from the caller's result and the graph's outputs into a new tensor: no
output is shared between calls, and on one stream the next replay cannot
overwrite the graph's outputs before a fold has read them. The eager
chain runs instead on the CPU, in debug mode (its checks read the
operands on the host, which a replay would skip) and while the current
stream is itself being captured (an outer graph then records the
kernels). A failed capture raises. `graphs` holds at most GRAPH_CACHE
keys, the least recently used evicted first, and `clear_plan_cache`
empties it. A replay adds the launches counted during its capture to
`_build.launches`, and its route to `block_stats`, so every call counts
the same launches and route whichever way it ran. One set of keys used at
several levels (`keys[:ds]` of a deeper key, as a CKKS chain uses its
relinearisation key below the top level) gives a graph a level: the shape
and ds are in the key.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import time
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from .. import _build, _device, nt
from ..eltwise import ops, torch_kernels
from ..limb import (add128, cond_sub64_half, mul64_wide, mulhi64,
                    mulhi64_approx, mult_mod_barrett_rows, reduce_mod_lazy64,
                    shoup_mul_lazy, shoup_mul_lazy_approx, to_numpy,
                    to_tensor)
from ..ntt import (cuda_ntt, get_plan, get_rns_plan, hier,
                   register_clear_hook, rns, torch_ntt)
from ..utils import check, profiling

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint64
_L = ctypes.c_int64
_MAC_PARTS_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _P)
_SPREAD_ARGS = (_P, _P, _P, _U, _U, _U, _I, _L, _I, _P)
_FOLD_ARGS = (_P, _P, _P, _P, _P, _I, _I, _L, _I, _P)

# K10's largest group of key components (csrc/key_switch.cu MAC_GROUP):
# a group's accumulator pairs live in registers, and t is read once a
# group.
MAC_GROUP = 4


def _column(rows, device) -> torch.Tensor:
    """Per-row constants (a list of u64 lists) as a (len, rows) int64
    tensor on `device`."""
    return to_tensor(np.array(rows, dtype=np.uint64), device)


@functools.lru_cache(maxsize=None)
def constants(moduli: tuple, msf: tuple, ds: int, device: torch.device
              ) -> SimpleNamespace:
    """The host-computed constants of one basis, on `device`.

    mac (5, ds + 1): q, floor(2^64/q), 2^64 mod q, mu and shift of each
    row (the decomposition primes, then the key prime); spread (3, ds):
    q_i, floor(2^64/q_i) and fix_i = q_i - (floor(qk/2) mod q_i); fold
    (3, ds): q_i, w_i = the modswitch factor reduced at IMF 8, and its
    Shoup precondition wp_i. The plain versions read the same values as
    the Python lists moduli, fix, w and wp."""
    qk = moduli[-1]
    rows = list(moduli[:ds]) + [qk]
    barr = [nt.barrett_factor(1, 64, q) for q in rows]
    mus, shifts = zip(*(nt.barrett_mult_constants(q) for q in rows))
    half = qk >> 1
    fix = [q - nt.barrett_reduce_64(half, q, b)
           for q, b in zip(rows[:ds], barr[:ds])]
    w = [nt.reduce_mod(f, q, 8) for f, q in zip(msf, rows[:ds])]
    wp = [nt.barrett_factor(wi, 64, q) for wi, q in zip(w, rows[:ds])]
    return SimpleNamespace(
        qk=qk, qk_barr=barr[-1], qk_half=half, moduli=rows[:ds], fix=fix,
        w=w, wp=wp,
        mac=_column([rows, barr, [(1 << 64) % q for q in rows], mus,
                     shifts], device),
        spread=_column([rows[:ds], barr[:ds], fix], device),
        fold=_column([rows[:ds], w, wp], device))


register_clear_hook(constants.cache_clear)


# -- plain versions ------------------------------------------------------------

def mac_flush_plain(t: torch.Tensor, keys: torch.Tensor, consts: torch.Tensor,
                    ds: int, kc: int, kms: int,
                    approx: bool = False) -> torch.Tensor:
    """t (ds + 1, ds, n), keys (ds, kc, kms, n) -> (ds + 1, kc, n): the
    128-bit sums over j of t[i][j] * keys[j][k][key_idx(i)], reduced mod
    q_i (with the approximate quotients of `_barrett_reduce_128` where
    `approx`), where key_idx(i) is i for the decomposition rows and kms - 1
    for the key prime's row. The key rows are gathered by slicing, which
    needs no index tensor (and so no host copy inside a CUDA graph)."""
    k_rows = torch.cat([keys[:, :, :ds], keys[:, :, kms - 1:kms]], dim=2)
    k_rows = k_rows.permute(2, 0, 1, 3).contiguous()     # (ds + 1, ds, kc, n)
    hi = lo = torch.zeros_like(k_rows[:, 0])
    for j in range(ds):
        p_hi, p_lo = mul64_wide(t[:, j, None, :], k_rows[:, j])
        hi, lo = add128(hi, lo, p_hi, p_lo)
    q, q_barr, r_mod, mu, shift = (consts[c].view(-1, 1, 1) for c in range(5))

    def reduce(x):
        if approx:
            r = cond_sub64_half(x - mulhi64_approx(x, q_barr) * q, 2 * q)
        else:
            r = x - mulhi64(x, q_barr) * q
        return cond_sub64_half(r, q)

    folded = mult_mod_barrett_rows(reduce(hi), r_mod, q, mu, shift, approx)
    return cond_sub64_half(folded + reduce(lo), q)


def mac_flush_parts_plain(off: torch.Tensor, diag: torch.Tensor,
                          last: torch.Tensor, keys: torch.Tensor,
                          consts: torch.Tensor, ds: int, kc: int, kms: int,
                          approx: bool = False) -> torch.Tensor:
    """`mac_flush_plain` of the block assembled from its three parts
    (`assemble`)."""
    return mac_flush_plain(assemble(off, diag, last), keys, consts, ds, kc,
                           kms, approx)


def spread_plain(x: torch.Tensor, c: SimpleNamespace,
                 approx: bool = False) -> torch.Tensor:
    """x (kc, n) in [0, 2qk) -> (ds, kc, n) in [0, 2 q_i); the reductions
    with the approximate quotient where `approx`."""
    v = torch_kernels.barrett_reduce(x + c.qk_half, c.qk, 1, approx)
    out = []
    for q, fix in zip(c.moduli, c.fix):
        r = torch_kernels.reduce_mod(v, q, q, 1, approx) if c.qk > q else v
        out.append(r + fix)
    return torch.stack(out)


def fold_plain(result: torch.Tensor, tpp: torch.Tensor, tntt: torch.Tensor,
               c: SimpleNamespace, approx: bool = False) -> torch.Tensor:
    """result (kc, ds, n), tpp (>= ds rows, kc, n), tntt (ds, kc, n) ->
    (kc, ds, n); the Shoup product with the approximate quotient where
    `approx`."""
    out = []
    for i, (q, w, wp) in enumerate(zip(c.moduli, c.w, c.wp)):
        x = reduce_mod_lazy64(tpp[i] + 4 * q - tntt[i], q, 8)
        prod = (shoup_mul_lazy_approx(x, w, wp, q) if approx
                else shoup_mul_lazy(x, w, wp, q))
        prod = cond_sub64_half(prod, q)
        out.append(cond_sub64_half(result[:, i] + prod, q))
    return torch.stack(out, dim=1)


# -- the kernel wrappers ---------------------------------------------------------

def _name(kernel: str, approx: bool) -> str:
    return kernel + (".approx" if approx else "")


def mac_flush_parts(off: torch.Tensor, diag: torch.Tensor, last: torch.Tensor,
                    keys: torch.Tensor, c: SimpleNamespace, ds: int, kc: int,
                    kms: int, approx: bool = False) -> torch.Tensor:
    """K10 (its approximate-quotient instantiation where `approx`) on the
    block `assemble(off, diag, last)`, read in its three parts where they
    lie: one launch on the GPU, counted as "K10";
    `mac_flush_parts_plain` on the CPU."""
    if not _build.on_card(off, diag, last, keys, c.mac):
        return mac_flush_parts_plain(off, diag, last, keys, c.mac, ds, kc,
                                     kms, approx)
    n = diag.shape[-1]
    out = torch.empty((ds + 1, kc, n), dtype=torch.int64, device=diag.device)
    if n == 0:
        return out
    fn = _build.function("key_switch", "hexl_ks_mac_flush_parts",
                         _MAC_PARTS_ARGS)
    _build.launch_on(diag.device, _name("K10", approx), fn, off.data_ptr(),
                     diag.data_ptr(), last.data_ptr(), keys.data_ptr(),
                     out.data_ptr(), c.mac.data_ptr(), ds, kc, kms, n,
                     int(approx))
    return out


def spread(x: torch.Tensor, c: SimpleNamespace,
           approx: bool = False) -> torch.Tensor:
    """K11's spread (approximate where `approx`) on the GPU, `spread_plain`
    on the CPU."""
    if not _build.on_card(x, c.spread):
        return spread_plain(x, c, approx)
    ds = c.spread.shape[1]
    out = torch.empty((ds,) + tuple(x.shape), dtype=torch.int64,
                      device=x.device)
    fn = _build.function("key_switch", "hexl_ks_spread", _SPREAD_ARGS)
    _build.launch_on(x.device, _name("K11", approx), fn, x.data_ptr(),
                     out.data_ptr(), c.spread.data_ptr(), c.qk, c.qk_barr,
                     c.qk_half, ds, x.numel(), int(approx))
    return out


def fold(result: torch.Tensor, tpp: torch.Tensor, tntt: torch.Tensor,
         c: SimpleNamespace, approx: bool = False) -> torch.Tensor:
    """K11's fold (approximate where `approx`) on the GPU, `fold_plain` on
    the CPU."""
    if not _build.on_card(result, tpp, tntt, c.fold):
        return fold_plain(result, tpp, tntt, c, approx)
    kc, ds, n = result.shape
    out = torch.empty_like(result)
    fn = _build.function("key_switch", "hexl_ks_fold", _FOLD_ARGS)
    _build.launch_on(result.device, _name("K11", approx), fn,
                     result.data_ptr(), tpp.data_ptr(), tntt.data_ptr(),
                     out.data_ptr(), c.fold.data_ptr(), ds, kc, n,
                     int(approx))
    return out


@functools.lru_cache(maxsize=None)
def _others_index(d: int, device: torch.device) -> torch.Tensor:
    """(d, d - 1) int64 on `device`: row i lists 0 .. d-1 without i."""
    return torch.tensor([[j for j in range(d) if j != i] for i in range(d)],
                        dtype=torch.int64, device=device)


def others(x: torch.Tensor) -> torch.Tensor:
    """x (d, ...) -> (d, d - 1, ...): row i holds x's rows j != i, in
    order (one gather)."""
    return x[_others_index(x.shape[0], x.device)]


def assemble(off: torch.Tensor, diag: torch.Tensor,
             last: torch.Tensor) -> torch.Tensor:
    """off (d, d - 1, ...), diag (d, ...), last (d, ...) -> (d + 1, d, ...):
    row i < d holds off[i] with diag[i] inserted at position i, row d is
    last."""
    d = diag.shape[0]
    out = torch.empty((d + 1, d) + tuple(diag.shape[1:]), dtype=diag.dtype,
                      device=diag.device)
    square = out[:d].reshape((d * d,) + tuple(diag.shape[1:]))
    square[1:].view((d - 1, d + 1) + tuple(diag.shape[1:]))[:, :d] = \
        off.reshape((d - 1, d) + tuple(diag.shape[1:]))
    square[::d + 1] = diag
    out[d] = last
    return out


# -- the graph of the chain on the card (module docstring) ---------------------

# The most keys `graphs` holds. SEAL's deepest CKKS chain at 2^15
# ({60, 40 x 19, 60}) multiplies at 19 levels, and a graph at ds 15 holds
# about 0.25 GB of device memory.
GRAPH_CACHE = 32
# graph_key -> None (seen once, run eagerly) or `capture`'s entry, the
# least recently used first.
graphs: collections.OrderedDict = collections.OrderedDict()
# The card calls that ran the chain eagerly, captured it, replayed it;
# `capture_s`, the host seconds spent in `capture`; `pool_bytes`, the
# device bytes the held graphs' memory pools reserve (what
# `torch.cuda.memory_reserved` grew by over each capture, less the entries
# evicted or cleared since).
graph_stats: collections.Counter = collections.Counter()
# The card calls of the stacked branch by the route of the base-conversion
# block (`block_route`): "fused" or "staged"; a replay counts its
# capture's route. `clear_plan_cache` leaves it alone.
block_stats: collections.Counter = collections.Counter()


def graph_key(stream: int, t_target, keys, n, ds, kms, kc, moduli,
              msf) -> tuple:
    """What a graph of the chain holds fixed: t_target's device and the
    `stream` it runs on, the shape, the basis, the keys' address and shape,
    the approximate flag and the route rules in force."""
    return (t_target.device, stream, n, ds, kms, kc, moduli, msf,
            keys.data_ptr(), tuple(keys.shape), ops.approx_for(t_target),
            rns.cluster_for, hier.cross_form, cuda_ntt.polys_per_cta)


def _release(entry) -> None:
    """Let a dropped graph's pending replays finish before its memory
    goes, and take its pool off `pool_bytes`."""
    if entry is None:
        return
    graph_stats["pool_bytes"] -= entry.pool_bytes
    if entry.t_static.is_cuda:
        torch.cuda.synchronize(entry.t_static.device)


def lookup(key, make):
    """The cache's bookkeeping for one card call of `key`: None where the
    key is new (the caller runs the chain eagerly), `make()`'s entry where
    it was seen once, the cached entry after; counts the call in
    `graph_stats` and evicts beyond GRAPH_CACHE keys."""
    if key not in graphs:
        graph_stats["eager"] += 1
        graphs[key] = None
        while len(graphs) > GRAPH_CACHE:
            _release(graphs.popitem(last=False)[1])
        return None
    graphs.move_to_end(key)
    entry = graphs[key]
    if entry is None:
        entry = graphs[key] = make()
        graph_stats["captures"] += 1
    else:
        graph_stats["replays"] += 1
    return entry


def _clear_graphs() -> None:
    for entry in graphs.values():
        _release(entry)
    graphs.clear()


# The graphs hold the addresses of the cached plans' descriptors and of
# the constants.
register_clear_hook(_clear_graphs)


def capture(t_target, keys, n, ds, kms, kc, moduli, msf) -> SimpleNamespace:
    """`switch` through the kernel wrappers, captured into a CUDA graph on
    a static input of t_target's shape and device (the current device):
    the entry holding the graph, its input `t_static`, its outputs `tpp`
    and `t_ntt`, the constants and flag the fold takes, the launches the
    chain makes, the route of its block and the bytes its pool reserves.
    The capture runs nothing, so the launches and the route it counted are
    taken off `_build.launches` and `block_stats` again; `graph` adds
    them. Adds to `capture_s` and `pool_bytes`."""
    t0 = time.perf_counter()
    t_static = torch.empty_like(t_target)
    cuda_graph = torch.cuda.CUDAGraph()
    before = collections.Counter(_build.launches)
    routes = collections.Counter(block_stats)
    # thread_local: an unsafe call of this thread inside the capture
    # raises, other threads' calls are left alone.
    with torch.cuda.graph(cuda_graph, stream=torch.cuda.Stream(),
                          capture_error_mode="thread_local"):
        # Read after `torch.cuda.graph` has emptied the allocator's cache:
        # what is reserved from here on is the graph's own pool.
        reserved = torch.cuda.memory_reserved(t_target.device)
        tpp, t_ntt, c, approx = switch(WRAPPERS, t_static, keys, n, ds, kms,
                                       kc, moduli, msf)
    pool_bytes = torch.cuda.memory_reserved(t_target.device) - reserved
    launched = collections.Counter(_build.launches) - before
    _build.launches.clear()
    _build.launches.update(before)
    routed = block_stats - routes
    block_stats.clear()
    block_stats.update(routes)
    graph_stats["pool_bytes"] += pool_bytes
    graph_stats["capture_s"] += time.perf_counter() - t0
    return SimpleNamespace(graph=cuda_graph, t_static=t_static, tpp=tpp,
                           t_ntt=t_ntt, c=c, approx=approx,
                           launches=launched, routes=routed,
                           pool_bytes=pool_bytes)


def graph(entry, t_target) -> None:
    """Replay `entry`'s graph on t_target, on the current stream, and count
    its launches and route."""
    entry.t_static.copy_(t_target)
    entry.graph.replay()
    _build.launches.update(entry.launches)
    block_stats.update(entry.routes)


def run(steps, result, t_target, keys, n, ds, kms, kc, moduli, msf):
    """`pipeline(steps, ...)`; on the card through the graph of the
    chain's key, except in debug mode, under an outer capture and on a
    key's first call."""
    if not t_target.is_cuda:
        return pipeline(steps, result, t_target, keys, n, ds, kms, kc,
                        moduli, msf)
    with torch.cuda.device(t_target.device):
        if check.debug_enabled() or torch.cuda.is_current_stream_capturing():
            graph_stats["eager"] += 1
            return pipeline(steps, result, t_target, keys, n, ds, kms, kc,
                            moduli, msf)
        args = (t_target, keys, n, ds, kms, kc, moduli, msf)
        entry = lookup(graph_key(torch.cuda.current_stream().cuda_stream,
                                 *args), lambda: steps.capture(*args))
        if entry is None:
            return pipeline(steps, result, *args)
        steps.graph(entry, t_target)
        return steps.fold(result, entry.tpp, entry.t_ntt, entry.c,
                          entry.approx)


def block_route(x: torch.Tensor, n: int, ds: int):
    """The route of the stacked branch's (ds, ds - 1, n) base-conversion
    block on x's device: "fused" where `rns.conv_fused` (K5.rns.conv reads
    the target's inverses where they lie), "staged" elsewhere on the card
    (the gather, K8.reduce.rows and the stacked forward), None off the
    card."""
    if not x.is_cuda:
        return None
    return "fused" if rns.conv_fused(x, n, ds) else "staged"


def _conv_fwd(t_intt, rplan, moduli):
    """WRAPPERS' conv_fwd: the block by `block_route`'s route, which a card
    call counts in `block_stats`: `rns.fwd_ntt_rns_conv` where "fused",
    else the gather, `ops.reduce_mod_rows` and `rns.fwd_ntt_rns`."""
    route = block_route(t_intt, rplan.n, rplan.k)
    if route is not None:
        block_stats[route] += 1
    if route == "fused":
        return rns.fwd_ntt_rns_conv(
            t_intt, rplan, ops.row_constants(tuple(moduli), t_intt.device),
            ops.approx_for(t_intt))
    return rns.fwd_ntt_rns(ops.reduce_mod_rows(others(t_intt), moduli, 1),
                           rplan, 4, 4)


# The steps of the pipeline: through the wrappers (kernels on the GPU),
# or through the plain versions on any device. `plan` gives what the
# transforms take for a prime, `rns_plan` what the stacked transforms take
# for a basis; `constants` the basis's constants, as the other steps take
# them; take (an index or a slice of the leading axis) and stack act on
# the pipeline's values (tensors here, sharded values in
# `parallel.composites`); `approx` says whether a value's device takes
# the approximate quotients, `row_flush` whether the flush is the JAX
# function's per-row one whatever the bit lengths (`pipeline`).
# `conv_fwd` is the stacked branch's base-conversion block, in WRAPPERS by
# `block_route`'s route; `mac_flush_parts` the multiply-accumulate of
# both branches. WRAPPERS also holds the graph path's `capture` and
# `graph` (`run`).
_TENSORS = dict(
    plan=get_plan, rns_plan=get_rns_plan, approx=ops.approx_for,
    row_flush=False,
    constants=lambda moduli, msf, ds, like: constants(moduli, msf, ds,
                                                      like.device),
    take=lambda x, i: x[i], stack=torch.stack)
WRAPPERS = SimpleNamespace(
    **_TENSORS, fwd=cuda_ntt.fwd_ntt, inv=cuda_ntt.inv_ntt,
    fwd_rns=rns.fwd_ntt_rns, inv_rns=rns.inv_ntt_rns,
    reduce=lambda x, q: ops.reduce_mod(x, q, q, 1),
    spread=spread, fold=fold, conv_fwd=_conv_fwd,
    mac_flush_parts=mac_flush_parts, capture=capture, graph=graph)
PLAIN = SimpleNamespace(
    **_TENSORS, fwd=torch_ntt.fwd_ntt, inv=torch_ntt.inv_ntt,
    fwd_rns=rns.fwd_ntt_rns_plain, inv_rns=rns.inv_ntt_rns_plain,
    reduce=lambda x, q: torch_kernels.reduce_mod(x, q, q, 1,
                                                 ops.approx_for(x)),
    conv_fwd=lambda x, rplan, moduli: rns.fwd_ntt_rns_conv_plain(
        x, rplan, ops.row_constants(tuple(moduli), x.device),
        ops.approx_for(x)),
    mac_flush_parts=lambda off, diag, last, keys, c, ds, kc, kms, approx:
        mac_flush_parts_plain(off, diag, last, keys, c.mac, ds, kc, kms,
                              approx),
    spread=spread_plain, fold=fold_plain)
# WRAPPERS with each step inside the span `hexl.ks.<entry>`: what
# `key_switch` takes where `profiling.on()`.
TRACED = SimpleNamespace(**{
    name: profiling.traced(f"hexl.ks.{name}", step) if callable(step)
    else step for name, step in vars(WRAPPERS).items()})


def flush_approx(steps, moduli, ds: int, approx: bool) -> bool:
    """Whether the flush takes the approximate quotients: only where the
    JAX key switch runs `_barrett_reduce_128`, which takes them under its
    switch (key_switch.py:34-51) — its per-row branch, for flushed rows
    (the ds decomposition primes and the key prime) of differing bit
    lengths (key_switch.py:191-192, 210-224; its other case, one row, is
    refused by `arguments`), and every row of its mesh key switch
    (parallel/composites.py:138, `steps.row_flush`). Its stacked branch,
    `_barrett_reduce_128_rows` (:191-209), stays exact."""
    rows = tuple(moduli[:ds]) + (moduli[-1],)
    return approx and (steps.row_flush
                       or len({q.bit_length() for q in rows}) > 1)


def switch(steps, t_target, keys, n, ds, kms, kc, moduli, msf):
    """The key switch's steps up to and including the mod-down's forward
    NTTs, with their lazy ranges, over the values and steps of `steps`
    (WRAPPERS, PLAIN, or a mesh's): (tpp, t_ntt, c, approx), what the fold
    takes besides result. Where the ds > 1 decomposition primes are
    distinct, the transforms that differ only in the prime run stacked, as
    the JAX function runs them (key_switch.py:105-160): the target's
    inverses, the base-converted targets as one (ds, ds - 1, n) block and
    the mod-down's forwards; else one call a prime."""
    c = steps.constants(moduli, msf, ds, t_target)
    approx = steps.approx(t_target)
    key_plan = steps.plan(n, moduli[-1])
    flush = flush_approx(steps, moduli, ds, approx)
    stacked = ds > 1 and len(set(moduli[:ds])) == ds
    # The target's inverse NTTs, (2, 1), as one stacked value.
    if stacked:
        rplan = steps.rns_plan(n, moduli[:ds])
        t_intt = steps.inv_rns(t_target, rplan, 2, 1)
    else:
        plans = [steps.plan(n, q) for q in moduli[:ds]]
        t_intt = steps.stack([steps.inv(steps.take(t_target, j), plans[j],
                                        2, 1) for j in range(ds)])
    # The key prime's row: every target base-converted to qk and forward-
    # transformed at (4, 4), one batched transform.
    key_row = steps.fwd(steps.reduce(t_intt, moduli[-1]), key_plan, 4, 4)
    # Row i < ds: the other targets base-converted to q_i and forward-
    # transformed at (4, 4), one (ds, ds - 1, n) block; the target itself
    # (already in NTT form) is the row's term at j = i.
    if stacked:
        off = steps.conv_fwd(t_intt, rplan, moduli[:ds])
    elif ds > 1:
        off = steps.stack([steps.fwd(steps.reduce(steps.stack(
            [steps.take(t_intt, j) for j in range(ds) if j != i]), q),
            plans[i], 4, 4) for i, q in enumerate(moduli[:ds])])
    else:
        off = steps.stack([steps.take(t_intt, slice(0, 0))])
    tpp = steps.mac_flush_parts(off, t_target, key_row, keys, c, ds, kc, kms,
                                flush)
    # Mod-down: the key prime's row, (2, 2) inverse; the spread to every
    # q_i; the (4, 4) forward NTTs (stacked where the transforms above
    # were).
    t_last = steps.inv(steps.take(tpp, ds), key_plan, 2, 2)
    spread_out = steps.spread(t_last, c, approx)
    if stacked:
        t_ntt = steps.fwd_rns(spread_out, rplan, 4, 4)
    else:
        t_ntt = steps.stack([steps.fwd(steps.take(spread_out, i), plans[i],
                                       4, 4) for i in range(ds)])
    return tpp, t_ntt, c, approx


def pipeline(steps, result, t_target, keys, n, ds, kms, kc, moduli, msf):
    """The key switch over the values and steps of `steps`: `switch`, then
    the fold into result."""
    return steps.fold(result, *switch(steps, t_target, keys, n, ds, kms, kc,
                                      moduli, msf))


def arguments(result, t_target, n, ds, kms, rns, kc, moduli, keys, msf,
               device):
    moduli = tuple(int(q) for q in moduli)
    msf = tuple(int(f) for f in msf)
    if rns != ds + 1 or kms < ds + 1 or len(moduli) != kms \
            or len(msf) != ds or ds < 1 or kc < 1:
        raise ValueError(
            "key_switch needs rns_modulus_size == decomp_modulus_size + 1, "
            "key_modulus_size moduli (at least ds + 1) and ds "
            "modswitch factors")
    (r, t, k), _ = _device.operands((result, t_target, keys), device)
    # As in the JAX function, numpy keys alone do not make the result numpy.
    host = not all(isinstance(v, torch.Tensor) for v in (result, t_target))
    for name, x, shape in (("result", r, (kc, ds, n)),
                           ("t_target", t, (ds, n)),
                           ("key_switch_keys", k, (ds, kc, kms, n))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
    return (r, t, k, n, ds, kms, kc, moduli, msf), host


def key_switch(result, t_target, n: int, decomp_modulus_size: int,
               key_modulus_size: int, rns_modulus_size: int,
               key_component_count: int, moduli: Sequence[int],
               key_switch_keys, modswitch_factors: Sequence[int],
               device=None):
    """CKKS key switch; returns result plus the switched target, in a new
    array (`result` is left as it is, as in the JAX package).

    result:            (key_component_count, decomp_modulus_size, n)
    t_target:          (decomp_modulus_size, n), NTT form
    key_switch_keys:   (decomp_modulus_size, key_component_count,
                        key_modulus_size, n)
    moduli:            key_modulus_size moduli (decomp primes + key prime)
    modswitch_factors: decomp_modulus_size factors qk^-1 mod qi
    rns_modulus_size must be decomp_modulus_size + 1, as the JAX function
    requires. Operands and devices as in `dyadic_multiply`."""
    if not profiling.on():
        args, host = arguments(result, t_target, n, decomp_modulus_size,
                                key_modulus_size, rns_modulus_size,
                                key_component_count, moduli, key_switch_keys,
                                modswitch_factors, device)
        out = run(WRAPPERS, *args)
        return to_numpy(out) if host else out
    with profiling.Span("hexl.key_switch"):
        with profiling.Span(profiling.CHECKS):
            args, host = arguments(result, t_target, n, decomp_modulus_size,
                                    key_modulus_size, rns_modulus_size,
                                    key_component_count, moduli,
                                    key_switch_keys, modswitch_factors,
                                    device)
        out = run(TRACED, *args)
        return to_numpy(out) if host else out


def key_switch_plain(result, t_target, n: int, decomp_modulus_size: int,
                     key_modulus_size: int, rns_modulus_size: int,
                     key_component_count: int, moduli: Sequence[int],
                     key_switch_keys, modswitch_factors: Sequence[int],
                     device=None):
    """`key_switch` through the plain versions only, on any device: what
    the kernels are held against on the card."""
    args, host = arguments(result, t_target, n, decomp_modulus_size,
                            key_modulus_size, rns_modulus_size,
                            key_component_count, moduli, key_switch_keys,
                            modswitch_factors, device)
    out = pipeline(PLAIN, *args)
    return to_numpy(out) if host else out
