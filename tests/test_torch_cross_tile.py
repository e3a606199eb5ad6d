"""K5's tiled form (csrc/cross_tile.cuh) on the CPU: a plain model of its
walk, its form rule, its shared memory and its bank conflicts.

The model runs what each CTA runs: tiles of D rows x C = TILE_COEFFS / D
columns, taken in the persistent walk's waves (the last one ragged), the
stages as radix passes over rows in the kernel's order (groups of 2^k
rows, the butterflies of torch_ntt, the twiddle entries the kernel
reads). It is held bit for bit against `hier.cross_fwd_plain`/
`cross_inv_plain` (which tests/test_torch_hier.py holds against the JAX
split), directly and through the split at N = 2^15 against the NumPy
oracle. The kernel itself is held against the same plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py phase 3).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch.ntt import get_plan, hier, torch_ntt

CSRC = pathlib.Path(hier.__file__).resolve().parents[1] / "csrc"
WAVE = 3   # CTAs of the modelled persistent grid: ragged last waves
SMEM_PER_CTA = 232448  # the most shared memory a Hopper CTA can opt into


def _source_constant(name, path="cross_tile.cuh"):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / path).read_text())[1])


TILE_THREADS = _source_constant("TILE_THREADS")
TILE_RING = _source_constant("TILE_RING")


def tile_passes(log_d):
    """The stage counts of the tiled form's radix passes at D = 2^log_d
    (cross_tile.cuh TileShape): at most three a pass, as even as they can
    be, the first ones larger."""
    passes = (log_d + 2) // 3
    return [log_d // passes + (p < log_d % passes) for p in range(passes)]


def _prime(q_bits, n):
    if q_bits == 62:
        return jnt.generate_primes(1, 61, False, ntt_size=n)[0]
    return jnt.generate_primes(1, q_bits, True, ntt_size=n)[0]


def _pairs(half, k):
    """The local indices J of a stage's butterflies (J, J + half) in a
    group of 2^k."""
    return [(u // half) * 2 * half + u % half for u in range(1 << (k - 1))]


def _tile_walk(tiles, w, wp, plan, log_d, forward, omf, final_stage, word,
               num_groups, groups, scheme):
    """One wave of tiles (t, D, C) with their blocks' groups (t, 1) of
    num_groups: the passes of cross_tile_fwd_kernel /
    cross_tile_inv_kernel."""
    d, q = 1 << log_d, plan.q
    rows = [tiles[:, r, :] for r in range(d)]
    passes = tile_passes(log_d)
    first = 0
    for p, k in enumerate(passes):
        last = p + 1 == len(passes)
        ls = log_d - first - k if forward else first
        for g in range(d >> k):
            base = (g & ((1 << ls) - 1)) | ((g >> ls) << (ls + k))
            idx = [base + (j << ls) for j in range(1 << k)]
            v = [rows[r] for r in idx]
            b = g >> ls
            for i in range(k):
                if forward:
                    half = 1 << (k - 1 - i)
                    at = (num_groups + groups) * (1 << (first + i)) + (b << i)
                    for j in _pairs(half, k):
                        e = at + (j >> (k - i))
                        v[j], v[j + half] = torch_ntt.fwd_butterfly(
                            v[j], v[j + half], w[e], wp[e], q, scheme, word)
                    continue
                half, m_log = 1 << i, log_d - 1 - first - i
                if final_stage and last and i + 1 == k:
                    for j in _pairs(half, k):
                        pair = torch_ntt.inv_final(
                            torch.stack((v[j], v[j + half]), -1), plan, omf,
                            word, scheme)
                        v[j], v[j + half] = pair[..., 0], pair[..., 1]
                    continue
                at = (d - (2 << m_log)) * num_groups + (groups << m_log) \
                    + (b << (k - 1 - i))
                for j in _pairs(half, k):
                    e = at + (j >> (i + 1))
                    v[j], v[j + half] = torch_ntt.inv_butterfly(
                        v[j], v[j + half], w[e], wp[e], q, scheme, word)
            for j, r in enumerate(idx):
                rows[r] = v[j]
        first += k
    return torch.stack(rows, 1)


def tile_launch_model(x, w, wp, plan, log_d, log_lc, forward, omf=1,
                      final_stage=True, word=64, log_groups=0,
                      scheme="exact"):
    """The plain model of one launch of the tiled form, with
    `hier.cross_launch`'s arguments: tile t of the (batch, D, lc) view is
    columns [c0, c0 + C) of block t / (lc / C), taken in waves of WAVE."""
    d, lc, c = 1 << log_d, 1 << log_lc, hier.tile_columns(log_d)
    assert lc >= c
    blocks = x.reshape(-1, d, lc // c, c)
    tiles = blocks.permute(0, 2, 1, 3).reshape(-1, d, c)   # tile-major
    per_block = lc // c
    block_of = torch.arange(tiles.shape[0]) // per_block
    group = (block_of % (1 << log_groups)).reshape(-1, 1)
    out = torch.empty_like(tiles)
    for t0 in range(0, tiles.shape[0], WAVE):
        sl = slice(t0, t0 + WAVE)
        out[sl] = _tile_walk(tiles[sl], w, wp, plan, log_d, forward, omf,
                             final_stage, word, 1 << log_groups, group[sl],
                             scheme)
    out = out.reshape(-1, per_block, d, c).permute(0, 2, 1, 3)
    return out.reshape(x.shape)


def model_cross(x, plan, forward, omf=1, word=64, scheme="exact"):
    """`hier.cross` with every launch in the model of the tiled form."""
    launches = hier.cross_launches(x.shape[-2].bit_length() - 1,
                                   x.shape[-1].bit_length() - 1)
    for log_rows, log_lc, log_groups, log_table in (
            launches if forward else launches[::-1]):
        w, wp = hier._cross_table(plan, x.device, forward, word,
                                  1 << log_table)
        x = tile_launch_model(x, w, wp, plan, log_rows, log_lc, forward,
                              omf, log_groups == 0, word, log_groups,
                              scheme)
    return x


# (q bits, word, scheme): both words, every scheme, the top of the ranges.
ARITH = [(60, 64, "exact"), (62, 64, "exact"), (29, 32, "exact"),
         (59, 64, "lean16"), (60, 64, "lean8")]
WIDE = {"exact": (4, 2), "lean16": (16, 8), "lean8": (8, 4)}


def _held(log_d, log_w, batch, q_bits, word, scheme, seed):
    d, width = 1 << log_d, 1 << log_w
    n = d * width
    q = _prime(q_bits, n)
    plan = get_plan(n, q)
    rng = np.random.default_rng(seed)
    fwd_bound, inv_bound = (f * q for f in WIDE[scheme])
    xf = to_tensor(rng.integers(0, fwd_bound, size=(batch, d, width),
                                dtype=np.uint64), "cpu")
    xi = to_tensor(rng.integers(0, inv_bound, size=(batch, d, width),
                                dtype=np.uint64), "cpu")
    assert torch.equal(model_cross(xf, plan, True, 1, word, scheme),
                       hier.cross_fwd_plain(xf, plan, word, scheme))
    for omf in (1, 2):
        assert torch.equal(model_cross(xi, plan, False, omf, word, scheme),
                           hier.cross_inv_plain(xi, plan, omf, word, scheme))


@pytest.mark.parametrize("q_bits,word,scheme", ARITH)
@pytest.mark.parametrize("log_d", range(1, 7))
def test_tile_model_matches_plain(log_d, q_bits, word, scheme):
    """Every D of one launch, at lc = C and 2C, batch 3 (ragged waves)."""
    c = hier.tile_columns(log_d)
    for log_w in (c.bit_length() - 1, c.bit_length()):
        _held(log_d, log_w, 3, q_bits, word, scheme, log_d + log_w)


@pytest.mark.parametrize("q_bits,word,scheme", ARITH)
@pytest.mark.parametrize("log_d,log_w", [(7, 7), (8, 7), (9, 6)])
def test_tile_model_two_launch_form(log_d, log_w, q_bits, word, scheme):
    """D > 64 rows: the across launch (final stage) and the within launch
    (row groups, no final stage), as `hier.cross` runs them."""
    _held(log_d, log_w, 1, q_bits, word, scheme, log_d)


def test_tile_model_dist_blocks():
    """DistNTT's blocks: the exchanged (batch, D, L/D) block of a position
    (rows at stride N/D of the whole transform, a narrow width), and a
    slice of its columns."""
    n, d = 1 << 14, 8
    q = _prime(60, n)
    plan = get_plan(n, q)
    rng = np.random.default_rng(5)
    x = to_tensor(rng.integers(0, q, size=(2, d, n // d), dtype=np.uint64),
                  "cpu")
    for block in (x, x[..., :n // d // 4].contiguous()):
        assert torch.equal(model_cross(block, plan, True),
                           hier.cross_fwd_plain(block, plan))
        assert torch.equal(model_cross(block, plan, False, 2),
                           hier.cross_inv_plain(block, plan, 2))


def test_tile_model_through_the_split_vs_oracle():
    """The split at N = 2^15 with the model's cross pass, against the
    NumPy oracle of the JAX package (forward OMF 4, inverse OMF 2)."""
    n = 1 << 15
    q = _prime(60, n)
    plan, jp = get_plan(n, q), jax_get_plan(n, q)
    rng = np.random.default_rng(6)
    x = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    xt = to_tensor(x, "cpu").reshape(2, hier.shards(plan), hier.LOCAL_N)
    mine = hier.local_fwd_plain(model_cross(xt, plan, True).reshape(2, n),
                                plan, 4)
    want = np.stack([ref.fwd_ntt_radix2(v, q, jp.rop, jp.prop, 1, 4)
                     for v in x])
    np.testing.assert_array_equal(to_numpy(mine), want)
    y = rng.integers(0, 2 * q, size=(2, n), dtype=np.uint64)
    loc = hier.local_inv_plain(to_tensor(y, "cpu"), plan)
    mine = model_cross(loc.reshape(xt.shape), plan, False, 2).reshape(2, n)
    want = np.stack([ref.inv_ntt_radix2(v, q, jp.irop, jp.pirop, 2, 2)
                     for v in y])
    np.testing.assert_array_equal(to_numpy(mine), want)


def test_persistent_walk_covers_every_tile_once():
    """tile_walk: CTA b takes tiles b, b + G, ...; the copies of tile
    t + RING G go to the slot that tile t leaves, which is the slot the
    CTA reads next time round; every tile once, for any grid and count."""
    ring = TILE_RING
    for tiles in (1, 2, 7, 64, 133):
        for grid in (1, 3, 132, 200):
            grid = min(grid, tiles)
            seen = []
            for b in range(grid):
                slots = {r: b + r * grid for r in range(ring)}  # prologue
                i = 0
                for t in range(b, tiles, grid):
                    assert slots[i % ring] == t
                    seen.append(t)
                    slots[i % ring] = t + ring * grid
                    i += 1
            assert sorted(seen) == list(range(tiles))


def test_form_rule_takes_every_block_a_caller_passes():
    """Every (..., D, w) block a caller can pass (the split's D = 2 .. 64 at
    lc = 2^14, DistNTT's exchanged blocks and their slices of D up to
    2^10 rows, the two-launch form): each launch's form is one the launch
    takes, the tiled form only where a row holds a tile, and the rule
    takes the tiled form at the split's D = 64 in u64 alone."""
    for log_d in range(1, 11):
        for log_w in range(0, 21 - log_d):
            for log_rows, log_lc, log_groups, _ in hier.cross_launches(
                    log_d, log_w):
                assert 1 <= log_rows <= 6
                for word in (64, 32):
                    for scheme in torch_ntt.SCHEMES:
                        for aligned in (True, False):
                            form = hier.cross_form(log_rows, log_lc, 1, word,
                                                   scheme, aligned)
                            forms = hier.cross_forms(log_rows, log_lc,
                                                     aligned)
                            assert form in forms
                            if form == "tile":
                                assert 1 << log_lc >= hier.tile_columns(
                                    log_rows) and aligned
    for log_d in range(1, 7):
        for word in (64, 32):
            want = "tile" if (log_d, word) == (6, 64) else "column"
            assert hier.cross_form(log_d, hier.LOG_LOCAL, 2, word) == want
    assert hier.cross_form(6, 3, 2) == "column"   # lc < C = 16


def test_rings_fit_shared_memory():
    """Every instantiation's twiddle tables (D G entries each, in its word)
    and ring of u64 tiles, at the most row groups a launch takes
    (MAX_LOG_TABLE entries), fit a Hopper CTA."""
    max_log_table = _source_constant("MAX_LOG_TABLE", "ntt_hier.cu")
    for word_bytes in (8, 4):
        smem = (2 * word_bytes << max_log_table) \
            + TILE_RING * hier.TILE_COEFFS * 8
        assert smem <= SMEM_PER_CTA


def test_tile_constants_mirror_the_source():
    src = (CSRC / "cross_tile.cuh").read_text()
    assert hier.TILE_COEFFS == 1 << _source_constant("LOG_TILE")
    assert "TILE_COEFFS = 1 << LOG_TILE" in src
    assert "LOG_C = LOG_TILE - LOG_D" in src
    assert "PASSES = (LOG_D + 2) / 3" in src
    assert "LOG_D / PASSES + (p < LOG_D % PASSES ? 1 : 0)" in src
    for log_d in range(1, 7):
        passes = tile_passes(log_d)
        assert sum(passes) == log_d and max(passes) <= 3


def _banks_ok(addrs, nbytes):
    """addrs: the byte address each of a warp's 32 lanes accesses. True if
    each phase of the request (32 lanes of 4 bytes, 16 of 8, 8 of 16)
    falls on distinct banks."""
    lanes = 128 // nbytes
    for p0 in range(0, 32, lanes):
        banks = np.concatenate([(addrs[p0:p0 + lanes] // 4 + k) % 32
                                for k in range(nbytes // 4)])
        if len(np.unique(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("log_d", range(1, 7))
def test_tile_accesses_are_free_of_bank_conflicts(log_d):
    """Every shared-memory access of a warp in the tiled form: the
    cp.async copies (16 bytes a lane) and each pass's loads and stores of
    each register (8-byte words; the single word's tile is u64 too)."""
    c = hier.tile_columns(log_d)
    log_c = c.bit_length() - 1
    threads = np.arange(TILE_THREADS)
    for i0 in range(0, hier.TILE_COEFFS // 2, TILE_THREADS):
        i = i0 + threads
        row, col = i >> (log_c - 1), (i << 1) & (c - 1)
        addr = (row * c + col) * 8
        for warp in range(0, TILE_THREADS, 32):
            assert _banks_ok(addr[warp:warp + 32], 16)
    first = 0
    for k in tile_passes(log_d):
        for ls in (log_d - first - k, first):   # forward, inverse
            for w0 in range(0, hier.TILE_COEFFS >> k, TILE_THREADS):
                w = w0 + threads
                col, g = w & (c - 1), w >> log_c
                base = (g & ((1 << ls) - 1)) | ((g >> ls) << (ls + k))
                for j in range(1 << k):
                    addr = (((base + (j << ls)) << log_c) + col) * 8
                    for warp in range(0, TILE_THREADS, 32):
                        assert _banks_ok(addr[warp:warp + 32], 8), (k, ls, j)
        first += k
