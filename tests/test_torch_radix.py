"""The contract of the radix walk's shard launch (K6 with a shard base and
a period), through its plain version `hier.local_launch_plain`, against
JAX.

A transform of N = 2^(log_n + log_d) runs its first log_d forward stages
(the cross stages), then the local pass on its 2^log_d shards. Launched
with a shard base and a period, chunk c of the local pass is shard
base + (c mod 2^log_sub): taking the shards of each polynomial in runs of
2^log_sub at every base and putting the outputs back in place gives the
whole forward, held bit for bit (lazy outputs included) against the JAX
engine on the CPU (its exact body) and the NumPy oracle `hexl_tpu.ref`;
the inverse likewise, its local pass first. The lean schemes and the
single word are held against the split's plain local pass.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from hexl_tpu import nt as jnt
from hexl_tpu import ref
from hexl_tpu.ntt import NTT as JaxNTT
from hexl_tpu.ntt import get_plan as jax_get_plan
from hexl_tpu_torch import get_plan
from hexl_tpu_torch.limb import to_numpy, to_tensor
from hexl_tpu_torch import poly
from hexl_tpu_torch.ntt import cuda_ntt, hier, torch_ntt

import chip_smoke


def _by_runs(x, plan, forward, omf, log_n, log_d, log_sub, scheme="exact",
             word=64):
    """The local pass of x (batch, N) as launches of 2^log_sub shards of
    each polynomial at bases 0, 2^log_sub, ..., put back in place."""
    d, period, n = 1 << log_d, 1 << log_sub, 1 << log_n
    shards = x.reshape(x.shape[0], d, n)
    out = torch.empty_like(shards)
    for base in range(0, d, period):
        run = shards[:, base:base + period].reshape(-1, n)
        out[:, base:base + period] = hier.local_launch_plain(
            run, plan, forward, omf, log_n, log_d, base, log_sub, word,
            scheme).reshape(x.shape[0], period, n)
    return out.reshape(x.shape)


@pytest.mark.parametrize("log_n,log_d,log_sub", [(1, 2, 1), (3, 2, 1),
                                                 (5, 3, 2), (6, 1, 0),
                                                 (4, 3, 3)])
def test_shard_runs_make_the_jax_transform(log_n, log_d, log_sub):
    n_big = 1 << (log_n + log_d)
    q = jnt.generate_primes(1, 60, True, ntt_size=n_big)[0]
    plan, jp, theirs = get_plan(n_big, q), jax_get_plan(n_big, q), \
        JaxNTT(n_big, q)
    rng = np.random.default_rng(log_n * 16 + log_d)
    x = rng.integers(0, q, size=(2, n_big), dtype=np.uint64)
    xt = to_tensor(x, "cpu")
    cross = torch_ntt.fwd_stages(xt, plan, 1, 1 << log_d)
    lazy = _by_runs(cross, plan, True, 4, log_n, log_d, log_sub)
    np.testing.assert_array_equal(to_numpy(lazy),
                                  np.asarray(theirs.forward(x, 1, 4)))
    np.testing.assert_array_equal(
        to_numpy(lazy), np.stack([ref.fwd_ntt_radix2(v, q, jp.rop, jp.prop,
                                                     1, 4) for v in x]))
    assert torch.equal(_by_runs(cross, plan, True, 1, log_n, log_d, log_sub),
                       lazy % q)
    loc = _by_runs(xt, plan, False, 1, log_n, log_d, log_sub)
    back = torch_ntt.inv_final(
        torch_ntt.inv_stages(loc, plan, 1 << log_n, n_big // 2), plan, 1)
    np.testing.assert_array_equal(to_numpy(back),
                                  np.asarray(theirs.inverse(x, 1, 1)))


@pytest.mark.parametrize("q_bits,word,scheme", [(50, 64, "lean16"),
                                                (60, 64, "lean8"),
                                                (29, 32, "exact")])
def test_shard_runs_in_every_form(q_bits, word, scheme):
    """At N = 2^15 (two shards of 2^14) and N = 2^17 (eight), one launch
    per shard, against the split's plain local pass."""
    rng = np.random.default_rng(q_bits)
    for log_d, log_sub in ((1, 0), (3, 1)):
        n_big = 1 << (14 + log_d)
        q = jnt.generate_primes(1, q_bits, True, ntt_size=n_big)[0]
        plan = get_plan(n_big, q)
        x = to_tensor(rng.integers(0, 4 * q, size=(1, n_big),
                                   dtype=np.uint64), "cpu")
        for omf in (1, 4):
            assert torch.equal(
                _by_runs(x, plan, True, omf, 14, log_d, log_sub, scheme,
                         word),
                hier.local_fwd_plain(x, plan, omf, word, scheme))
        x = x % (2 * q)
        assert torch.equal(
            _by_runs(x, plan, False, 1, 14, log_d, log_sub, scheme, word),
            hier.local_inv_plain(x, plan, word, scheme))


CSRC = pathlib.Path(chip_smoke.ROOT) / "hexl_tpu_torch" / "csrc"
_RETURN = re.compile(r"return f\(Index<(\d+)>\{\}, Index<(\w+)>\{\}, "
                     r"Index<(\d+)>\{\}\)")


def _shapes(source, function, **constants):
    """The shapes a with_shape-style dispatch returns, statement by
    statement: [(case, conditions, LOGR, G, LOGN)], case the log_n of the
    enclosing `case` (or of `if (log_n == k)`), "ge3" for the default's
    `if (log_n >= 3)` and "lt3" for its last return; conditions the
    guards before the return (`U32`, `two_per_sm`, `fft_unrolled`, or
    "else" for the branch after `} else {`). G may name one of
    `constants`."""
    src = (CSRC / source).read_text()
    body = src[src.index(f"static int {function}("):]
    body = body[:body.index("\n}\n")]
    out, case, branch = [], None, set()
    for statement in body.split(";"):
        m = re.search(r"case (\d+):", statement)
        if m:
            case = int(m.group(1))
        if "} else {" in statement or "default:" in statement:
            branch, case = ({"else"} if "else" in statement else set()), None
        if "fft_unrolled" in statement:
            branch = {"fft_unrolled"}
        m = _RETURN.search(statement)
        if not m:
            continue
        where = case
        k = re.search(r"if \(log_n == (\d+)\)", statement)
        if k:
            where = int(k.group(1))
        if "log_n >= 3" in statement:
            where, branch = "ge3", set()
        elif where is None:
            where = "lt3"
        guards = set(branch) | {g for g in ("U32", "two_per_sm")
                                if g in statement}
        g = m.group(2)
        out.append((where, guards, int(m.group(1)),
                    constants[g] if g in constants else int(g),
                    int(m.group(3))))
    return out


def _threads_ok(logr, g, logn, served, limit):
    """G groups of R = 2^LOGR a thread over 2^log_n / (G R) <= limit
    threads cover every transform of log_n in `served`; LOGN is 0 or
    log_n."""
    for log_n in served:
        threads = (1 << log_n) // (g << logr)
        assert g * threads * (1 << logr) == 1 << log_n, (log_n, g)
        assert 1 <= threads <= limit and logn in (0, log_n), (log_n, g)


def test_spill_check_counts_every_radix_shape():
    """chip_smoke.py's register check expects one radix instantiation per
    form and shape: the shapes are those `with_shape` (the NTT's: seven
    for u64, ten for u32: 2^15, K7's, and the two-CTAs-a-SM forms of 2^13
    and 2^14), `with_packed_shape` (K2's two), poly.cu's (K3's) and
    `fft_with_shape` (K12's: six in complex double and float, three in
    double-float) dispatch to."""
    ntt = _shapes("ntt_block.cuh", "with_shape")
    u64 = [sh for sh in ntt if "U32" not in sh[1]]
    assert (len(ntt), len(u64)) == (10, 7)
    # Forward: three u64 schemes and u32; inverse: with and without the
    # final stage, each in the three u64 schemes and u32.
    assert chip_smoke.RADIX_INSTANTIATIONS == (3 + 6) * 7 + (1 + 2) * 10
    fft = _shapes("fft.cu", "fft_with_shape", G13=1)
    unrolled = [sh for sh in fft if "else" not in sh[1]]
    rolled = [sh for sh in fft if "fft_unrolled" not in sh[1]]
    assert (len(unrolled), len(rolled)) == (6, 3)
    assert chip_smoke.FFT_RADIX_INSTANTIATIONS == 2 * (6 + 6 + 3)
    # K2: forward and inverse in three schemes at the two packed shapes.
    block = (CSRC / "ntt_block.cuh").read_text()
    packed = block[block.index("static int with_packed_shape("):]
    packed = packed[:packed.index("\n}\n")]
    assert len(re.findall(r"return f\(Index<(\d)>\{\}", packed)) == 2
    assert chip_smoke.PACKED_INSTANTIATIONS == 2 * 3 * 2
    # K3: the cluster form's degrees and the one-CTA form's kernels.
    src = (CSRC / "poly.cu").read_text()
    cluster = re.findall(r"f\(poly_cluster_kernel<(\d+)>", src)
    cta = re.findall(r"f\(poly_cta_kernel<(\d+), (\d+)>", src)
    assert sorted(int(k) for k in cluster) == [12, 13, 14]
    assert len(set(cta)) == 6
    assert chip_smoke.POLY_INSTANTIATIONS == len(cluster) + len(set(cta))
    # Every other launch is the cluster's, through cudaLaunchKernelEx.
    assert "<<<" not in src.replace("kernel<<<batch", "")
    for name in ("_Z16radix_fwd_kernelIyLi0ELi3ELi2ELi14EEvPKyPyS1_S1_yiiiii",
                 "_Z16radix_inv_kernelIjLi0ELi3ELi1ELi0ELb0EEvPKyPyS1_S1_y8"
                 "InvFinalIT_Eiiiii",
                 "_Z20fft_radix_fwd_kernelI2CxIdELi3ELi1ELi13EEv4PtrsS2_S2_"
                 "NT_1SEiii",
                 "_Z23radix_packed_fwd_kernelILi0ELi3EEvPKyPyS1_S1_yiiii",
                 "_Z19poly_cluster_kernelILi14EEvPKyS1_PyS1_S1_S1_S1_7Barrett8"
                 "InvFinalIyE",
                 "_Z15poly_cta_kernelILi3ELi13EEvPKyS1_PyS1_S1_S1_S1_7Barrett8"
                 "InvFinalIyEi"):
        assert chip_smoke.NEW_INSTANTIATION.search(name)


@pytest.mark.parametrize("word", [64, 32])
def test_every_ntt_radix_shape_fits_a_cta(word):
    """Every shape `with_shape` gives a word (u64 up to 2^14, u32 up to
    2^15, its 512-thread forms too) covers the transforms it serves with
    G x threads x R = 2^log_n and at most 1024 threads; u64 refuses
    2^15."""
    shapes = [sh for sh in _shapes("ntt_block.cuh", "with_shape")
              if word == 32 or "U32" not in sh[1]]
    explicit = {sh[0] for sh in shapes if isinstance(sh[0], int)}
    assert explicit == ({10, 11, 12, 13, 14, 15} if word == 32
                        else {10, 11, 12, 13, 14})
    for where, guards, logr, g, logn in shapes:
        served = ([where] if isinstance(where, int) else
                  range(3, 10) if where == "ge3" else range(1, 3))
        _threads_ok(logr, g, logn, served, 1024)
        if "two_per_sm" in guards:
            assert (1 << where) // (g << logr) == 512


@pytest.mark.parametrize("policy,threads", [("F64", 1024), ("F32", 1024),
                                            ("DfP", 512)])
def test_every_fft_radix_shape_fits_a_cta(policy, threads):
    """K12's radix walk at every log_n 1..13: each shape `fft_with_shape`
    gives the policy covers what it serves with G x threads x R = 2^log_n
    and at most the policy's THREADS (read from fft_arith.cuh)."""
    arith = (CSRC / "fft_arith.cuh").read_text()
    declared = [int(v) for v in re.findall(
        r"static constexpr int THREADS = (\d+);", arith)]
    assert declared == [1024, 512]       # Cx<T> (F64, F32), then DfP
    unrolled = policy != "DfP"
    shapes = [sh for sh in _shapes("fft.cu", "fft_with_shape",
                                   G13=(1 << 10) // threads)
              if ("else" if unrolled else "fft_unrolled") not in sh[1]]
    explicit = {sh[0] for sh in shapes if isinstance(sh[0], int)}
    assert explicit == ({10, 11, 12, 13} if unrolled else {13})
    top = min(explicit) - 1
    for where, _, logr, g, logn in shapes:
        served = ([where] if isinstance(where, int) else
                  range(3, top + 1) if where == "ge3" else range(1, 3))
        _threads_ok(logr, g, logn, served, threads)


def _slot(i, logr):
    return i ^ ((i >> logr) & 31)


def _base(u, s, logr):
    return (u & ((1 << s) - 1)) | ((u >> s) << (s + logr))


def _conflict_free(slots, nbytes):
    """slots (lanes, R): the slot each consecutive lane accesses with each
    register. True if, for every register, the lanes of each phase of a
    warp's request (32 lanes of 4-byte values, 16 of 8, 8 of 16) fall on
    distinct banks."""
    words = nbytes // 4
    lanes = 32 // words
    for w0 in range(0, len(slots), lanes):
        phase = slots[w0:w0 + lanes]            # (lanes, R)
        banks = ((phase[:, None, :] * words
                  + np.arange(words)[None, :, None]) % 32)
        banks = np.sort(banks.reshape(-1, phase.shape[1]), axis=0)
        if (banks[1:] == banks[:-1]).any():
            return False
    return True


def _passes(log_n, logr):
    """The register-bit positions s of every pass of the forward and the
    inverse (radix_fwd_passes, radix_inv_passes)."""
    passes = (log_n + logr - 1) // logr
    return ({max(log_n - p * logr - logr, 0) for p in range(passes)}
            | {min(p * logr, log_n - logr) for p in range(passes)})


@pytest.mark.parametrize("log_n", range(1, 16))
def test_radix_exchange_is_free_of_bank_conflicts(log_n):
    """radix.cuh's swizzle: in every pass's layout (each register of a
    warp's 32 consecutive groups), the shared-memory accesses of 4-, 8-
    and 16-byte values fall on distinct banks within each phase of the
    request (32 lanes, 16 and 8), and the slots of a pass are a
    permutation of [0, n)."""
    logr = 3 if log_n >= 3 else 1
    n = 1 << log_n
    u = np.arange(n >> logr)
    for s in _passes(log_n, logr):
        slots = _slot(_base(u, s, logr)[:, None]
                      + (np.arange(1 << logr)[None, :] << s), logr)
        assert np.array_equal(np.sort(slots.ravel()), np.arange(n))
        for nbytes in (4, 8, 16):
            assert _conflict_free(slots, nbytes), (s, nbytes)


@pytest.mark.parametrize("log_n", range(1, 13))
def test_packed_layout_is_free_of_bank_conflicts(log_n):
    """K2's P transforms a CTA (ntt_block.cuh PACKED): virtual group U =
    p n/R + u sits where K1's group U of a P n transform would, at p n plus
    the base of group u of transform p, in every pass of every P the
    kernel takes (up to 1024 threads); the slots are a permutation of
    [0, P n), every pass's 8-byte accesses are free of bank conflicts, and
    where a transform's groups lie in one warp (n/R <= 32) every slot is
    only ever touched by one warp, so that the warp's barrier suffices."""
    logr = 3 if log_n >= 3 else 1
    n, g = 1 << log_n, log_n - logr
    top = cuda_ntt.max_polys_per_cta(n)
    assert top << g == cuda_ntt.MAX_PACK_THREADS
    p = 2
    while p <= top:
        big = np.arange(p << g)
        poly, u = big >> g, big & ((1 << g) - 1)
        owner = {}
        for s in _passes(log_n, logr) | {log_n - logr}:
            base = _base(big, s, logr)
            assert np.array_equal(base, poly * n + _base(u, s, logr))
            slots = _slot(base[:, None]
                          + (np.arange(1 << logr)[None, :] << s), logr)
            assert np.array_equal(np.sort(slots.ravel()), np.arange(p * n))
            assert _conflict_free(slots, 8), (p, s)
            if g <= 5:
                for lane, row in enumerate(slots):
                    for slot in row:
                        assert owner.setdefault(slot, lane // 32) == \
                            lane // 32, (p, s, slot)
        p *= 2


@pytest.mark.parametrize("log_n", range(12, 15))
def test_cluster_product_mapping_is_free_of_bank_conflicts(log_n):
    """K3's cluster form (csrc/poly.cu): CTA r reads position r N/2 + j of
    both forward outputs (one local, one remote) at the forward's slot of
    r N/2 + j, which is r N/2 plus the half's own slot of j from N = 2^9
    on (the form serves 2^12-2^14), so the product lands in the inverse's
    layout with no exchange; the
    inverse's first-pass rows then read free of bank conflicts, and so do
    the final stage's reads of consecutive positions i and N/2 + i."""
    n, logr = 1 << log_n, 3
    half, threads = n // 2, n // 16
    j = np.arange(half)
    for r in (0, 1):
        assert np.array_equal(_slot(r * half + j, logr),
                              r * half + _slot(j, logr))
        rows = _slot(r * half + np.arange(threads)[:, None] * 8
                     + np.arange(8)[None, :], logr)
        assert _conflict_free(rows, 8)
        i = (r * half // 2 + np.arange(threads)[:, None]
             + np.arange(4)[None, :] * threads)
        assert _conflict_free(_slot(i, logr), 8)
        assert np.array_equal(_slot(i + half, logr), half + _slot(i, logr))


def test_cluster_form_needs_two_to_the_nine():
    """Below N = 2^9 the slot of N/2 + j is not N/2 plus the slot of j:
    the halves' layouts differ, so the cluster form (CLUSTER_DEGREES,
    from 2^12 where the card showed it faster) could not start lower."""
    for log_n in range(4, 9):
        half = 1 << (log_n - 1)
        j = np.arange(half)
        assert not np.array_equal(_slot(half + j, 3), half + _slot(j, 3))
    assert poly.CLUSTER_DEGREES == (1 << 12, 1 << 14)


@pytest.mark.parametrize("log_n", range(1, 14))
def test_one_cta_product_reads_both_operands(log_n):
    """K3's one-CTA form: b's position j rests at the slot of n + j, which
    lies in [n, 2n) (a's slots fill [0, n)), so writing the product over
    a's slots never touches b's; the inverse's first-pass rows read both
    free of bank conflicts."""
    logr = 3 if log_n >= 3 else 1
    n = 1 << log_n
    j = np.arange(n)
    assert np.array_equal(np.sort(_slot(n + j, logr)), n + j)
    rows = (np.arange(n >> logr)[:, None] << logr) + np.arange(1 << logr)
    for offset in (0, n):
        assert _conflict_free(_slot(offset + rows, logr), 8)
