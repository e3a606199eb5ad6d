#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hexl_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py

and, to time the radix walk's rows (K1, K2, K3, K6, K7 and K12) and the
stacked RNS transform's (RNS.prod, RNS.n14, RNS.n17, KS, KS.ntts) against
an earlier tree of the port unpacked
at PARENT (a `git archive` in a directory .gitignore lists), on the same
card in turns parent, this tree, this tree, parent:

    python3 chip_smoke.py --walk-ab PARENT

(K5's rows at D = 8 .. 64 among them; the key switch at every
KS_SHAPES entry, its transforms, and the graft pipeline; a DistNTT
position's local pass at every shape of the fifth path, and each
fifth-path call, one a graph replay; the streaming kernels' rows,
`stream_runs`: each K8 family and K4 at 2^22 elements, K4 at 2 x 2^12,
the approximate forms, the row ops, torch.remainder beside K8.reduce at
IMF 4, K10 and K10.approx at every KS_SHAPES entry at kc 2 and 1, each
with its share of the bytes bound; every row with its per-turn
medians). The streaming kernels' rows alone on the port at ROOT, and
STREAM_VARIANTS' copies of this tree (and PARENT's sources) in turns:

    python3 chip_smoke.py --stream-times ROOT
    python3 chip_smoke.py --stream-variants [PARENT [ROUNDS [NAMES]]]

K5 alone, at
every D in both words and forms, and the variants of its tiled form
against each other:

    python3 chip_smoke.py --k5-times
    python3 chip_smoke.py --k5-variants

The cluster form of the stacked transform (K1.rns.cl, K6.rns.cl): its
checks, its launch floor and the grid of its rule, `rns.cluster_for`
(every C against one CTA and the split variant, one prime at N = 2^12 ..
2^15 and batches to a wave; ROOT and BATCHES time a variant tree on a cut
grid); and the key switch launch by launch with each launch's one-CTA
grid and its split variant (K5 then K6 at L = 2^10 .. 2^13) on the port
at ROOT:

    python3 chip_smoke.py --cluster-times [ROOT BATCHES]
    python3 chip_smoke.py --ks-times ROOT

A DistNTT position's local pass (K6.shard, and K6.shard.cl where the
cluster rule routes it) at every shape the fifth path launches it, with
each C the card holds forced, and each fifth-path call replayed from a
CUDA graph with its launches, on the port at ROOT (default this tree);
and K6's forms for small shards (SHARD_VARIANTS) timed in turns:

    python3 chip_smoke.py --shard-times [ROOT]
    python3 chip_smoke.py --shard-variants

Phases, each of which fails the run (non-zero exit) if anything is wrong:
  1. the card: CUDA present; its name and power limit from nvidia-smi;
  2. build: every kernel compiled from csrc/ with nvcc for sm_90a, with
     the compiler's -Xptxas -v report (the run fails if a lean, approx,
     chain, radix-walk, K2, K3, K5 tiled-form or K16 instantiation of the
     NTT or the FFT-like, K3 in any of its four schemes, an eltwise body,
     K10 at any kc, a K9 or K11 approximate instantiation, or any of the
     133 stacked (RNS) or
     33 cluster-form instantiations, spills; the
     cluster form's most active clusters), K3's most active clusters per
     degree, six probe kernels whose SASS gives the IMADs of a 64x64 and
     of a 32x32 high and low product, of the lean and approx butterflies'
     approximate 64x64 high product and of the eltwise family's
     (mulhi64_approx), and a kernel with an empty body (K4's launch
     floor);
  3. every kernel against its plain PyTorch version on the card, bit-exact:
     K1/K2 over N x q x the IMF/OMF matrix x batch (K1 at every N from 2
     to 2^14); K2 at every N from 2 to 2^12, at every P its rule gives
     and every power-of-two P its kernel takes, in every scheme and
     IMF/OMF pair; K3 at every N from 2 to 2^14, batches 1, 2, 64 and
     133, in every form it takes (cluster, one CTA); K4; K5 and K6 (the
     cross and local passes of N > 2^14) at every N from 2^15 to 2^20
     for q just above 2^29, 2^50, 2^60 and 2^61 and the largest q below
     2^62, where 4q is just under 2^64 (the 29-bit one in both the u64 and
     the u32 instantiation), over the IMF/OMF matrix and a ragged batch;
     K7 (the single-word NTT) at every N from 2 to 2^15; K4 and K8 (the
     eltwise family: every op x word x IMF/OMF, every predicate with
     inputs and bounds on both sides of 2^63) for q of 20, 29, 49, 60 and
     61 bits and the largest prime below 2^62, and the streaming kernels
     at the edges of their 16-byte bodies (edge_kernel_checks: K4/K8
     with every approximate form, the row ops and K10 at every kc it is
     built for, at counts 1, 3, 5, 1023 and 2^22 + 3, inputs and outputs
     8 bytes off a 16-byte boundary, odd row lengths, empty tensors); K9
     (the dyadic product, one
     and four weights, moduli of mixed bit lengths); K10 and K11 (the key
     switch's multiply-accumulate with its flush, and its mod-down); K12
     and K13 (the FFT-like's block walks and cross pass) in f64, single
     and double-float at every n from 16 to 2^17, forward and inverse,
     with and without a scalar, bit-exact (no FMA contraction in the
     kernels); K14
     and K15 (the four-step NTT's folds) on the int32 planes of every pass
     at N in {2^8, 2^10, 2^14, 2^17} for five moduli over the IMF/OMF
     matrix; the parallel layer's kernels (parallel_kernel_checks): K5
     with a column stride on DistNTT's exchanged blocks for D in {2, 4, 8,
     16, 128} (two launches above 64 rows) and lc from 256/D up to 2^14
     (N <= 2^20), K6 with a shard base for L from
     2^10 to 2^16 and with a shard base and a period for shards of 2^11
     to 2^14 (both words, the lean schemes), and K16 at every stage of N in {2^10, 2^14, 2^17}, for
     q of 29 (q < 2^30, through the 64-bit walk), 30, 50, 60 and 61 bits;
     K5 in each of its forms (column, tiled; tile_kernel_checks) at every
     D from 2 to 64, batches 1, 2 and 3, D = 128 and 256 through the
     two-launch form (row groups, no final stage) and a position's
     intra-shard stages, in both words and every scheme; the stacked
     transform's kernels (rns_kernel_checks): K1.rns, K2.rns, K5.rns in
     each form and K6.rns against the plain stacked walk (and pass by pass
     against each row's plain pass) for k = 1, 3 and 16 primes of mixed
     bit lengths at N = 2^6, 2^10, 2^14, 2^15, 2^17 and 2^20, batches
     whose rows end in ragged CTAs, every IMF/OMF pair and scheme, and
     K4.rows and K8.reduce.rows; the cluster form (cluster_kernel_checks):
     K1.rns.cl and K6.rns.cl at every C (2, 4, 8, 16) and N from 2^12 to
     2^20 against the plain cluster walk, every IMF/OMF pair, and the
     one-prime calls routed to it at N = 2^12 .. 2^16; K6.shard.cl
     (shard_cluster_checks) at every C, L from 2^12 to 2^16, D = 2, 4
     and 8 and their positions, against its plain version; the "approx"
     scheme (approx_kernel_checks): K1/K2 at every N from 2 to 2^14 and
     K5/K6 from 2^15 to 2^20 for q just above 2^29, 2^50 and 2^60 and
     just below 2^61 over the IMF/OMF matrix, K3 in every form, K16 at
     every stage, K6 with a shard base, and K4/K8's approximate
     instantiations (five ops, the row ops) at every IMF/OMF for q of 20
     to 62 bits; the composites' approximate quotients and K3's lean
     forms (composite_approx_checks): K9.approx at one and three weights,
     K10.approx on bases whose flushed rows differ in bit length,
     K11.approx's spread and fold, K3 and K3.cta in lean16 and lean8 at
     every N from 2 to 2^14 in every form, each also against the exact
     form;
  4. seven main paths through the public entry points, each with the
     launch counts set to 0 just before it and read just after it.
     The first: NTT(2^14, 60-bit) forward and inverse at batch 256
     from numpy (K1); the __graft_entry__ pipeline (fwd OMF 4 ->
     eltwise_mult_mod IMF 4 -> inv) at 2^12, 50-bit, batch 2 (K1, K4);
     NTT(2^10, 29-bit) forward and inverse at batch 4096 (the single-word
     K7, as in the JAX engine); NTT(2^10, 49-bit) at batch 4096 (K1);
     NTT(2^6, 49-bit) at batch 8192 (K2); poly_mult_mod at (2^12, 50-bit,
     2) and (2^14, 60-bit, 64) (K3, the cluster form) and at (2^13,
     60-bit, 132) (K3.cta, the one-CTA form); RnsNTT at (2^14, 16
     primes, batch 16) (K1.rns) and (2^6, 3 primes, batch 4096) (K2.rns),
     one launch a direction for the basis.
     The second (N above 2^14 and the single-word regime): NTT(2^17,
     60-bit) and NTT(2^17, 29-bit) forward and inverse at batch 16 (K5/K6,
     then their u32 instantiation); NTT(2^14, 29-bit) at batch 256 (K7);
     NTT(2^20, 60-bit) at batch 2 (K5/K6 with 64 shards);
     rns_poly_mult_mod at N=2^17 x 16 primes of 50 bits (BASELINE.json's
     fifth configuration; stacked: K5.rns, K6.rns, K4.rows, 7 launches for
     the basis); RnsNTT(2^20, 3 primes) at batch 1 (K5.rns's tiled form,
     K6.rns). Every output is then held bit for
     bit against the plain version on the same inputs, poly_mult_mod at
     N = 64 against a schoolbook product in Python integers, and one
     prime of the RNS product against a NumPy product (exact float FFTs
     of 12-bit limbs).
     The third (the eltwise family and the SEAL-shim composites, see
     third_path): every eltwise op at its Xeon row's shape and at 2^22
     elements (64-bit and single-word), dyadic_multiply at 2^14 x 4 and
     2^17 x 16 primes, lr_mat_vec_mult with 16 weights, key_switch at the
     three Xeon shapes and at N=2^15 x ds 14; every output against the
     plain version, each key switch's launches (its transforms stacked
     over the decomposition primes), and a key switch at N=64 against
     Python integers.
     The fourth (see its comment in main): CKKS encode and decode through
     FFTLike at 2^14 slots, scale 2^40, batch 64, in auto (f64), single
     and double-float, the round trip within 1e-12 (1e-4 in single); the
     FFT-like at the Xeon rows' shapes; fwd_ntt_mxu/inv_ntt_mxu at (2^14,
     60-bit, 256) and (2^17, 60-bit, 16), bit-equal to NTT's outputs.
     The fifth (see its comment in main): the parallel layer on meshes of
     cuda:0 positions, one card holding every position: dist_rns_poly_mult
     at N=2^17 x 16 primes of 50 bits on the (2, 4) and (2, 8) meshes,
     DistNTT at bench.py's shape on (1, 8), (2, 4) (also with two overlap
     slices) and (1, 1), PipelineNTT on a ring of 8, dist_key_switch and
     dist_dyadic_multiply (K6.shard.cl launched, and K6 for the shards at
     a wave); every output against the port's single-device call and the
     plain path on the same inputs.
     The sixth (see its comment in main): the approximate-butterfly regime
     forced on: NTT(2^14) at 60 bits (lean8) and 59 bits (lean16) at batch
     256, NTT(2^17, 50-bit) at batch 16 (lean16, K5/K6), NTT(2^10, 49-bit)
     at batch 4096 (lean8, K1), NTT(2^6, 49-bit) at batch 8192 (lean8,
     K2), rns_poly_mult_mod at N=2^17 x 16 primes of
     50 bits; the K17 and K18 chains at the probes' shapes; every output
     against the plain lean path, fully reduced ones against the exact
     outputs, the K18 chains against each other; and, counted on their
     own, the "approx" scheme through the entry points (the scheme map
     forced to it): NTT(2^14, 60-bit) x 256, NTT(2^6) x 8192, NTT(2^17) x
     16, NTT(2^20) x 2, poly_mult_mod at (2^14, 64) and (2^13, 132),
     DistNTT(2^17) on (1, 8) with local_scheme="approx", PipelineNTT on a
     ring of 8, the five eltwise ops with an approximate body at 2^22
     elements and a key switch at 2^14 x ds 3, each output against its
     plain approx version and, fully reduced, the exact one; and, counted
     in a third window, the composites with the switch forced on:
     dyadic_multiply at N=2^17 x 16 primes and lr_mat_vec_mult
     (K9.approx), key_switch at N=2^15 x ds 14 over rows of two bit
     lengths (K10.approx, K11.approx), poly_mult_mod at (2^14, 64) and
     (2^13, 132) in lean8 and lean16 (K3.lean8, K3.cta.lean8, K3.lean16,
     K3.cta.lean16), dist_key_switch on a (2, 4) mesh of cuda:0 positions,
     each against the same call with the switch off;
     The seventh (seventh_path): the host-side modules through their entry
     points, in fresh processes where a cold start is what is measured:
     `prewarm` at (2^14, 60-bit, 256), (2^17, 60-bit, 16), (2^20, 60-bit,
     2) and (2^14, 29-bit, 256) and its MXU backend at 2^14 (K1, K5/K6,
     K7, K14/K15), its records printed, then the first public pair of each
     config against the same pair in a process that was not prewarmed;
     those plans saved to a file in one process and loaded in another,
     with the g++-built host library and with HEXL_TPU_DISABLE_NATIVE=1
     (build against load seconds; the first pairs on the loaded plans
     bit-equal to freshly built plans'); examples/example_torch.py on the
     card ("All examples passed."; K1-K7, K9-K11, K12/K13); and a
     torch.profiler trace (utils.profiling.trace) of 20 calls each of the
     graft pipeline, the N=2^15 x ds 14 key switch and eltwise_mult_mod
     at (2^13, 60-bit), broken down per call into wall time, device-busy
     time, idle share, launches and the host ops with the most self time,
     each traced output against its plain version;
  5. timings with CUDA events (median of 20): each kernel and its plain
     version at the main paths' shapes, beside the kernel's bound (the
     radix walk's rows, K1, K2, K3, K3.cta, K6, K6 with a shard base, the
     lean K1/K6, K7 and K12, on inputs that rotate beyond the 50 MB L2;
     K5 at every D from 2 to 64 (N x batch = 2^21) in both words and both
     forms, with its registers, CTAs per SM and the rule's form; K4 beside
     the empty kernel at its grid, its launch floor, and at 2^22
     elements); the
     fwd+inv pairs/s at N=2^14, 60-bit, batch 256, and at N=2^17 for
     60-bit and 29-bit q at batch 16, each against the Xeon reference of
     benchmarks/reference_baseline/baseline_results.json; the latency and
     launch count of the 16-prime RNS product; the public pairs/s of
     NTT(2^10, 29-bit) at batch 4096 (K7) against its Xeon rows; K8 per
     op family at 2^22 elements, K9, K10 and K11 beside their bounds; the
     public eltwise ops and dyadic_multiply per call against their Xeon
     rows; each key switch's latency, its kernels and NTTs replayed from
     CUDA graphs, and its launches per call; the transform pair with each
     number of polynomials per CTA forced, against the wrapper's choice,
     at every N from 2 to 2^12; the product with each of K3's forms
     forced at N from 2^9 to 2^14; the FFT-like pair with each number of
     transforms per CTA forced (K12's radix walk against its stage
     walk);
     K12/K13 per precision beside torch.fft.fft (the nearest library
     call, another function), K14/K15 beside torch._int_mm (the pass's
     matmul); the MXU pairs/s against the NTT's and the Xeon pair; the
     FFT-like against its Xeon rows; CKKS encode/decode per call; K6
     with a shard base, K5 with a column stride and K16 beside their
     bounds; each call of the fifth path per call, with its launches, its
     exchange copies and bytes, the mesh's count of distinct devices and
     the same work on one device; the lean instantiations, K17 and K18
     beside their bounds, the lean against the exact pair at each
     sixth-path shape (40 event timings each, in turns, with their spread,
     and graph replays), each approx row against its exact row (turns
     exact, approx, approx, exact, graph medians, with its bound; K9,
     K10, K11 and K3/K3.cta's lean forms among them), torch.remainder
     beside K8.reduce at IMF 4 (60-bit) and K8.reduce.u32 (the one PyTorch
     call of a reduce_mod to OMF 1 from below 4q), the
     RNS product both ways, and the chains in
     Gbfly/s; the stacked kernels (K1.rns, K2.rns, K5.rns in both forms,
     K6.rns, K4.rows, K8.reduce.rows) beside their bounds; RnsNTT's pairs
     at (2^14, 16 primes, 16) and (2^17, 16 primes, 1), the RNS product
     and the 2^15 x ds 14 key switch's transforms stacked against one call
     a prime, in turns, with launches and bounds; K5.rns's tiled form
     beside the single-modulus one on the same bytes; and the RNS
     product's routes at N <= 2^14 (stacked against K3 once a prime) at k
     = 2, 4, 16 and batches 1 to 256; K1.rns.cl and K6.rns.cl at the
     key switch's shapes beside their bound (bytes, IMADs or the launch
     floor: the cluster probe at the same grid and cluster shape), and
     every launch of the four key switches in the one-CTA form and in the
     rule's cluster; K6.shard.cl at the RNS product's (2, 8) shard beside
     its bound (the same floor rule).
It then prints one JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import importlib
import itertools
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; 132 SMs with 64 INT32
# lanes each (the IMAD rate is 64 per SM per clock).
HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64

SEED = 20261016
N10_BATCH = 4096   # the N=2^10 transforms of the first main path
PACKED_N, PACKED_BATCH = 1 << 6, 8192   # the first path's K2 pair
CTA_N, CTA_BATCH = 1 << 13, 132   # the first path's one-CTA product (K3.cta)
SPLIT_BATCH = 16   # the N=2^17 transforms of the second main path
RNS_PRIMES = 16    # BASELINE.json's RNS poly-mult: N=2^17 x 16 primes


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# One multiply each, never launched: their SASS (cuobjdump) gives the
# 32-bit IMADs that a 64x64 high and low product, a 32x32 high and low
# product, the approximate 64x64 high product of the lean and approx
# butterflies (csrc/modarith.cuh mulhi64_approx6, spelt out) and that of
# the eltwise family's approximate quotients (mulhi64_approx, spelt out)
# compile to: the operation term of each kernel's bound. Built here only,
# not into the port's libraries.
SASS_PROBES = r"""
extern "C" __global__ void sass_probe_mulhi64(const unsigned long long* a,
                                              const unsigned long long* b,
                                              unsigned long long* c) {
  c[0] = __umul64hi(a[0], b[0]);
}
extern "C" __global__ void sass_probe_mullo64(const unsigned long long* a,
                                              const unsigned long long* b,
                                              unsigned long long* c) {
  c[0] = a[0] * b[0];
}
extern "C" __global__ void sass_probe_mulhi64a6(const unsigned long long* a,
                                                const unsigned long long* b,
                                                unsigned long long* c) {
  const unsigned long long x = a[0], y = b[0];
  const unsigned x0 = (unsigned)x, x1 = (unsigned)(x >> 32);
  const unsigned y0 = (unsigned)y, y1 = (unsigned)(y >> 32);
  const unsigned h01 = (x0 >> 16) * (y1 >> 16) +
                       (((x0 & 0xFFFFu) * (y1 >> 16)) >> 16) +
                       (((x0 >> 16) * (y1 & 0xFFFFu)) >> 16);
  const unsigned h10 = (x1 >> 16) * (y0 >> 16) +
                       (((x1 & 0xFFFFu) * (y0 >> 16)) >> 16) +
                       (((x1 >> 16) * (y0 & 0xFFFFu)) >> 16);
  c[0] = (unsigned long long)x1 * y1 + h01 + h10;
}
extern "C" __global__ void sass_probe_mulhi64a(const unsigned long long* a,
                                               const unsigned long long* b,
                                               unsigned long long* c) {
  const unsigned long long x = a[0], y = b[0];
  const unsigned x0 = (unsigned)x, x1 = (unsigned)(x >> 32);
  const unsigned y0 = (unsigned)y, y1 = (unsigned)(y >> 32);
  const unsigned long long p01 = (unsigned long long)x0 * y1;
  const unsigned long long p10 = (unsigned long long)x1 * y0;
  const unsigned long long mid = (p01 & 0xFFFFFFFFull) +
                                 (p10 & 0xFFFFFFFFull);
  c[0] = (unsigned long long)x1 * y1 + (p01 >> 32) + (p10 >> 32) +
         (mid >> 32);
}
extern "C" __global__ void sass_probe_mulhi32(const unsigned int* a,
                                              const unsigned int* b,
                                              unsigned int* c) {
  c[0] = __umulhi(a[0], b[0]);
}
extern "C" __global__ void sass_probe_mullo32(const unsigned int* a,
                                              const unsigned int* b,
                                              unsigned int* c) {
  c[0] = a[0] * b[0];
}
"""
SASS_KINDS = ("mulhi64", "mullo64", "mulhi32", "mullo32", "mulhi64a6",
              "mulhi64a")


def start_sass_probes(nvcc: str, out_dir: pathlib.Path):
    """Start nvcc on the probes (to a cubin for sm_90a); returns the
    process and the cubin's path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src, cubin = out_dir / "sass_probes.cu", out_dir / "sass_probes.cubin"
    src.write_text(SASS_PROBES)
    proc = subprocess.Popen(
        [nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-o", str(cubin), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cubin


def sass_imads(proc, cubin: pathlib.Path) -> dict:
    """32-bit IMADs that each probe's product compiles to. An IMAD.WIDE (a
    32x32 -> 64 product) counts as two; moves, shifts and adds that the
    compiler spells IMAD do not count."""
    text, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the SASS probes:\n{text}")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts = {}
    for kind in SASS_KINDS:
        m = re.search(r"Function : sass_probe_%s\n(.*?)(?=Function : |\Z)"
                      % kind, sass, re.S)
        if m is None:
            raise RuntimeError(f"no SASS for sass_probe_{kind}")
        n = 0
        for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)", m.group(1)):
            if op.startswith("IMAD") and not op.startswith(
                    ("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")):
                n += 2 if ".WIDE" in op else 1
        if n == 0:
            raise RuntimeError(f"no IMAD found for {kind}")
        counts[kind] = n
    return counts


# A kernel with an empty body, launched with another kernel's grid: the
# least time a launch of that grid takes on the card, the floor under a
# bytes bound that a tiny shape cannot reach (K4 at 2 x 2^12 elements).
# Built here only, not into the port's libraries.
EMPTY_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__global__ void empty_probe() {}
extern "C" int launch_empty_probe(int blocks, int threads,
                                  cudaStream_t stream) {
  empty_probe<<<blocks, threads, 0, stream>>>();
  return (int)cudaGetLastError();
}
// The cluster form's launch floor: an empty kernel (syncs = 0), or one of
// `syncs` cluster barriers, on `blocks` CTAs in clusters of `cluster`
// with `smem` bytes of dynamic shared memory.
__global__ void cluster_probe(int syncs) {
  for (int i = 0; i < syncs; ++i) cooperative_groups::this_cluster().sync();
}
extern "C" int launch_cluster_probe(int blocks, int threads, int cluster,
                                    int smem, int syncs,
                                    cudaStream_t stream) {
  cudaFuncSetAttribute(cluster_probe,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cluster > 8)
    cudaFuncSetAttribute(cluster_probe,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, cluster_probe, syncs);
  return err ? err : (int)cudaGetLastError();
}
"""


def start_empty_probe(nvcc: str, out_dir: pathlib.Path):
    """Start nvcc on the empty probe (a shared library for sm_90a);
    returns the process and the library's path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "empty_probe.cu", out_dir / "libempty_probe.so"
    src.write_text(EMPTY_PROBE)
    proc = subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def empty_probe(proc, lib: pathlib.Path):
    """launch(blocks, threads[, cluster, smem, syncs]): the empty kernel
    on the current stream; with a cluster, the cluster probe (clusters of
    `cluster` CTAs, `smem` bytes of dynamic shared memory, `syncs` cluster
    barriers)."""
    import ctypes
    import torch
    text, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the empty probe:\n{text}")
    so = ctypes.CDLL(str(lib))
    fn, cl = so.launch_empty_probe, so.launch_cluster_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    cl.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = cl.restype = ctypes.c_int

    def launch(blocks, threads, cluster=None, smem=0, syncs=0):
        stream = torch.cuda.current_stream().cuda_stream
        err = (fn(blocks, threads, stream) if cluster is None else
               cl(blocks, threads, cluster, smem, syncs, stream))
        if err:
            raise RuntimeError(f"empty probe launch failed: cudaError {err}")
    return launch


def import_port(root: pathlib.Path) -> None:
    """Put the port at `root` (this tree, an earlier one or a variant copy)
    first on sys.path and import it; raises if another copy was
    imported."""
    sys.path.insert(0, str(root))
    import hexl_tpu_torch
    if not pathlib.Path(hexl_tpu_torch.__file__).is_relative_to(root):
        raise AssertionError(f"imported {hexl_tpu_torch.__file__}, not the "
                             f"port at {root}")


ELTWISE_THREADS = 128   # csrc/eltwise.cu THREADS


def eltwise_grid(count: int, resident: int) -> tuple:
    """(blocks, threads) of an eltwise launch of `count` elements
    (csrc/eltwise.cu grid_for: a CTA of ELTWISE_THREADS for every as many
    pairs of elements, at most the `resident` CTAs the card holds)."""
    pairs = (count + 1) // 2
    return (max(1, min(-(-pairs // ELTWISE_THREADS), resident)),
            ELTWISE_THREADS)


def negacyclic_product(a, b, q: int):
    """a*b mod (X^N + 1, q) for two uint64 vectors, independently of the
    port: each operand is cut into 12-bit limbs, every limb pair convolved
    with float64 FFTs (each sum < N * 2^24 <= 2^44, so rounding is exact;
    checked), and the limb products recombined and reduced in Python
    integers."""
    import numpy as np
    n = a.size
    limbs = -(-q.bit_length() // 12)

    def spectra(v):
        return [np.fft.rfft(((v >> np.uint64(12 * i)) & np.uint64(0xFFF))
                            .astype(np.float64), 2 * n) for i in range(limbs)]

    fa, fb = spectra(a), spectra(b)
    full = np.zeros(2 * n, dtype=object)
    for i in range(limbs):
        for j in range(limbs):
            conv = np.fft.irfft(fa[i] * fb[j], 2 * n)
            exact = np.rint(conv)
            if np.abs(conv - exact).max() > 0.25:
                raise AssertionError("FFT convolution not exact")
            full += exact.astype(np.int64).astype(object) << (12 * (i + j))
    return ((full[:n] - full[n:]) % q).astype(np.uint64)


def top_modulus(nt, q_bits: int, n: int = 1024) -> int:
    """A prime of q_bits (in (2^b, 2^(b+1)), = 1 mod 2n); "62" is the
    largest prime below 2^62 instead."""
    if q_bits == 62:
        return nt.generate_primes(1, 61, False, ntt_size=n)[0]
    return nt.generate_primes(1, q_bits, True, ntt_size=n)[0]


def placed(t, offset):
    """t copied `offset` words into a fresh buffer of its device: a
    contiguous view 8 bytes off a 16-byte boundary where offset is odd (as
    x[1:] is)."""
    import torch
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:].copy_(t.reshape(-1))
    return buf[offset:].view(t.shape)


def eltwise_cases(q, size, rng, dev, ops, plain64, plain32, nt, to_tensor,
                  offset=0):
    """(what, kernel, kernel's output, plain output) for every op of K4/K8
    under modulus q: both words where q < 2^30, the IMF/OMF matrix, the
    vector and scalar forms, every predicate with bounds on both sides of
    2^63 and inputs over the whole u64 range; every input `placed` at
    `offset`."""
    import numpy as np

    def rand(bound):
        return placed(to_tensor(rng.integers(0, bound - 1, size=size,
                                             dtype=np.uint64, endpoint=True),
                                dev), offset)

    def scalar(lo, hi):
        return int(rng.integers(lo, hi - 1, dtype=np.uint64, endpoint=True))

    for word in ((64, 32) if q < ops.SMALL_Q else (64,)):
        plain = plain32 if word == 32 else plain64
        sfx = "32" if word == 32 else ""
        a, b, s = rand(q), rand(q), scalar(0, q)
        for op in ("add", "sub"):
            fn = getattr(ops, f"{op}_mod")
            ref = getattr(plain, f"{op}_mod{sfx}")
            for rhs, form in ((b, "vector"), (s, "scalar")):
                yield (f"{op}_mod {form} word={word}",
                       ops.kernel_name(op, word), fn(a, rhs, q, word),
                       ref(a, rhs, q))
        for imf in (1, 2, 4):
            if q >= 1 << 62 or (word == 32 and imf * q >= 1 << 32):
                continue
            x, y = rand(imf * q), rand(imf * q)
            yield (f"mult_mod imf={imf} word={word}",
                   ops.kernel_name("mult", word),
                   ops.mult_mod(x, y, q, imf, word),
                   getattr(plain, f"mult_mod{sfx}")(x, y, q, imf))
        for imf in (1, 2, 4, 8):
            if q >= 1 << 61 or (word == 32 and imf * q >= 1 << 32):
                continue
            x, z = rand(imf * q), rand(imf * q)
            w = nt.reduce_mod(scalar(0, imf * q), q, imf)
            wp = nt.barrett_factor(w, word, q)
            ref = (plain.fma_mod32_preconned if word == 32
                   else plain.fma_mod_preconned)
            for c in (z, None):
                yield (f"fma_mod imf={imf} addend={c is not None} "
                       f"word={word}", ops.kernel_name("fma", word),
                       ops.fma_mod(x, w, wp, c, q, imf, word),
                       ref(x, w, wp, c, q, imf))
        for imf, omf in ((q, 1), (q, 2), (2, 1), (4, 1), (4, 2), (2, 2)):
            if word == 32 and imf == q:
                continue
            x = rand(1 << 64) if imf == q else rand(imf * q)
            yield (f"reduce_mod imf={'q' if imf == q else imf} omf={omf} "
                   f"word={word}", ops.kernel_name("reduce", word),
                   ops.reduce_mod(x, q, imf, omf, word),
                   getattr(plain, f"reduce_mod{sfx}")(x, q, imf, omf))
    full = rand(1 << 64)
    for cmp in plain64.CMP_NAMES:
        for bound in (scalar(0, 1 << 63), scalar(1 << 63, 1 << 64)):
            f = placed(full.clone(), offset)
            f[:7] = int(np.uint64(bound).view(np.int64))
            diff = scalar(1, 1 << 64)
            yield (f"cmp_add {cmp} bound={bound}", "K8.cmp",
                   ops.cmp_add(f, cmp, bound, diff),
                   plain64.cmp_add(f, cmp, bound, diff))
            diff = scalar(1, q)
            yield (f"cmp_sub_mod {cmp} bound={bound}", "K8.cmp",
                   ops.cmp_sub_mod(f, q, cmp, bound, diff),
                   plain64.cmp_sub_mod(f, q, cmp, bound, diff))
    if q < 1 << 62:
        a, b = rand(q), rand(q)
        for op in ("montgomery_form_in", "montgomery_form_out"):
            yield (op, "K8.mont", getattr(ops, op)(a, q),
                   getattr(plain64, op)(a, q))
        yield ("montgomery_mult_reduce", "K8.mont",
               ops.montgomery_mult_reduce(a, b, q),
               plain64.montgomery_mult_reduce(a, b, q))


def key_switch_inputs(rng, n, bits, kc, dev, nt, to_tensor):
    """(result, t_target, keys, moduli, msf) of a key switch over
    len(bits) - 1 decomposition primes and one key prime (distinct primes
    of the given bit lengths, = 1 mod 2n), as int64 tensors on dev."""
    import torch
    ds = len(bits) - 1
    moduli = []
    for b in bits:
        cands = nt.generate_primes(ds + 2, b, True, ntt_size=n)
        moduli.append(next(p for p in cands if p not in moduli))
    qk = moduli[-1]

    def rows(count):
        return torch.stack([to_tensor(rng.integers(0, q, n, dtype="uint64"),
                                      dev) for q in moduli[:count]])

    t = rows(ds)
    keys = torch.stack([torch.stack([rows(ds + 1) for _ in range(kc)])
                        for _ in range(ds)])
    msf = [nt.inverse_mod(qk % q, q) for q in moduli[:ds]]
    result = torch.stack([rows(ds) for _ in range(kc)])
    return result, t, keys, moduli, msf


def key_switch_oracle(result, t_target, keys, moduli, msf, nt):
    """The key switch in Python integers, as
    tests/test_experimental.py::_key_switch_oracle computes it, with
    transforms by direct evaluation: the forward NTT's output i is
    x(psi^(2 brv(i) + 1)) for the minimal primitive 2N-th root psi, and the
    inverse undoes it. Every step is a function of residues, so the
    oracle's fully reduced transforms give the lazy pipeline's result.
    Arguments are nested lists of ints; returns one."""
    kc, ds, n = len(result), len(t_target), len(t_target[0])
    log_n = n.bit_length() - 1
    brv = [nt.reverse_bits(i, log_n) for i in range(n)]
    powers = {}

    def table(q, inverse):
        if (q, inverse) not in powers:
            psi = nt.minimal_primitive_root(2 * n, q)
            if inverse:
                psi = pow(psi, -1, q)
            powers[(q, inverse)] = [pow(psi, k, q) for k in range(2 * n)]
        return powers[(q, inverse)]

    def fwd(x, q):
        pw = table(q, False)
        return [sum(x[j] * pw[(2 * brv[i] + 1) * j % (2 * n)]
                    for j in range(n)) % q for i in range(n)]

    def inv(y, q):
        pw, inv_n = table(q, True), pow(n, -1, q)
        return [inv_n * sum(y[i] * pw[(2 * brv[i] + 1) * j % (2 * n)]
                            for i in range(n)) % q for j in range(n)]

    qk = moduli[-1]
    t_intt = [inv(t_target[j], moduli[j]) for j in range(ds)]
    tpp = [[None] * (ds + 1) for _ in range(kc)]
    for i in range(ds + 1):
        q = moduli[i]
        acc = [[0] * n for _ in range(kc)]
        for j in range(ds):
            t_op = (t_target[j] if i == j
                    else fwd([v % q for v in t_intt[j]], q))
            for k in range(kc):
                key = keys[j][k][i]
                acc[k] = [s + a * b for s, a, b in zip(acc[k], t_op, key)]
        for k in range(kc):
            tpp[k][i] = [s % q for s in acc[k]]
    half = qk >> 1
    out = [[list(row) for row in comp] for comp in result]
    for k in range(kc):
        t_last = [(v + half) % qk for v in inv(tpp[k][ds], qk)]
        for i in range(ds):
            qi = moduli[i]
            t_ntt = fwd([v % qi + qi - half % qi for v in t_last], qi)
            out[k][i] = [(r + (p + 4 * qi - t) * msf[i]) % qi for r, p, t
                         in zip(out[k][i], tpp[k][i], t_ntt)]
    return out


XEON_MONT_MODULUS = 67280421310725   # the Xeon Montgomery rows' 47-bit q
BIG = (2, 16, 1 << 17)               # 2^22 elements: 2 polys x 16 primes
LR_WEIGHTS = 16
# (N, ds) of the key switches: the Xeon rows', then N=2^15 x 14 primes.
KS_SHAPES = ((1 << 14, 3), (1 << 14, 5), (1 << 15, 3), (1 << 15, 14))
# The third path's kernels beside its key switches' (`key_switch_launches`).
THIRD_PATH_KERNELS = ("K4", "K8.reduce.rows", "K8.add_sub", "K8.add_sub.u32",
                      "K8.mult.u32", "K8.fma", "K8.fma.u32", "K8.reduce",
                      "K8.reduce.u32", "K8.cmp", "K8.mont", "K9", "K10",
                      "K11")


def third_path(rng, dev, port, nt, plain64, plain32, dyadic, ks, to_tensor,
               rns_moduli):
    """The third main path as (what, kernel, call, plain): `call` runs a
    public entry point on tensors on the card, `plain` the plain version
    on the same inputs; `kernel` is the one whose output is compared."""
    import torch

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound - 1, size=shape,
                                      dtype="uint64", endpoint=True), dev)

    cases = []

    def add(what, kernel, call, plain):
        cases.append((what, kernel, call, plain))

    def eltwise_ops(shape, q, tag):
        """Every op at one shape under q; tag names the case."""
        word = 32 if q < 1 << 30 else 64
        p = plain32 if word == 32 else plain64
        sfx = "32" if word == 32 else ""
        k = lambda op: port.eltwise.ops.kernel_name(op, word)
        a, b = rand(shape, q), rand(shape, q)
        for op in ("add", "sub"):
            pub = getattr(port, f"eltwise_{op}_mod")
            ref = getattr(p, f"{op}_mod{sfx}")
            add(f"{op}_mod {tag}", k(op), lambda a=a, b=b, pub=pub:
                pub(a, b, q), lambda a=a, b=b, ref=ref: ref(a, b, q))
            add(f"{op}_mod scalar {tag}", k(op),
                lambda a=a, pub=pub: pub(a, 1234567 % q, q),
                lambda a=a, ref=ref: ref(a, 1234567 % q, q))
        for imf in (1, 2, 4):
            x, y = rand(shape, imf * q), rand(shape, imf * q)
            small = word == 32 and imf * q < 1 << 32
            ref = plain32.mult_mod32 if small else plain64.mult_mod
            add(f"mult_mod imf={imf} {tag}",
                port.eltwise.ops.kernel_name("mult", 32 if small else 64),
                lambda x=x, y=y, imf=imf: port.eltwise_mult_mod(x, y, q, imf),
                lambda x=x, y=y, imf=imf, ref=ref: ref(x, y, q, imf))
        for imf, omf in ((q, 1), (2, 1), (4, 1), (4, 2)):
            x = rand(shape, 1 << 64 if imf == q else imf * q)
            small = word == 32 and imf != q
            ref = plain32.reduce_mod32 if small else plain64.reduce_mod
            add(f"reduce_mod imf={'q' if imf == q else imf} omf={omf} {tag}",
                port.eltwise.ops.kernel_name("reduce", 32 if small else 64),
                lambda x=x, imf=imf, omf=omf: port.eltwise_reduce_mod(
                    x, q, imf, omf),
                lambda x=x, imf=imf, omf=omf, ref=ref: ref(x, q, imf, omf))
        fma_and_cmp(shape, q, tag)

    def fma_and_cmp(shape, q, tag, imfs=(1, 8)):
        for imf in imfs:
            x, z = rand(shape, imf * q), rand(shape, imf * q)
            small = q < 1 << 30 and imf * q < 1 << 32
            w = nt.reduce_mod(12345, q, imf)
            wp = nt.barrett_factor(w, 32 if small else 64, q)
            ref = (plain32.fma_mod32_preconned if small
                   else plain64.fma_mod_preconned)
            for c in (z, None):
                add(f"fma_mod imf={imf} addend={c is not None} {tag}",
                    port.eltwise.ops.kernel_name("fma", 32 if small else 64),
                    lambda x=x, c=c, imf=imf: port.eltwise_fma_mod(
                        x, 12345, c, q, imf),
                    lambda x=x, c=c, imf=imf, w=w, wp=wp, ref=ref: ref(
                        x, w, wp, c, q, imf))
        a = rand(shape, q)
        add(f"cmp_add nlt {tag}", "K8.cmp",
            lambda: port.eltwise_cmp_add(a, "nlt", q // 2, 42),
            lambda: plain64.cmp_add(a, "nlt", q // 2, 42))
        add(f"cmp_sub_mod nlt {tag}", "K8.cmp",
            lambda: port.eltwise_cmp_sub_mod(a, q, "nlt", q // 2, 42),
            lambda: plain64.cmp_sub_mod(a, q, "nlt", q // 2, 42))

    def montgomery(shape, q, tag):
        a, b = rand(shape, q), rand(shape, q)
        for op in ("form_in", "form_out"):
            add(f"montgomery_{op} {tag}", "K8.mont",
                lambda op=op: getattr(port, f"eltwise_montgomery_{op}")(a, q),
                lambda op=op: getattr(plain64, f"montgomery_{op}")(a, q))
        add(f"montgomery_mult_reduce {tag}", "K8.mont",
            lambda: port.eltwise_montgomery_mult_reduce(a, b, q),
            lambda: plain64.montgomery_mult_reduce(a, b, q))

    n12, n13, n14 = 1 << 12, 1 << 13, 1 << 14
    q = top_modulus(nt, 60, n12)
    a, b = rand((n12,), q), rand((n12,), q)
    for op in ("add", "sub"):
        pub, ref = getattr(port, f"eltwise_{op}_mod"), getattr(plain64,
                                                              f"{op}_mod")
        add(f"{op}_mod 2^12 60-bit", "K8.add_sub",
            lambda pub=pub, a=a, b=b, q=q: pub(a, b, q),
            lambda ref=ref, a=a, b=b, q=q: ref(a, b, q))
        add(f"{op}_mod scalar 2^12 60-bit", "K8.add_sub",
            lambda pub=pub, a=a, q=q: pub(a, 1234567, q),
            lambda ref=ref, a=a, q=q: ref(a, 1234567, q))
    for bits in (49, 60):
        q = top_modulus(nt, bits, n13)
        for imf in (1, 2, 4):
            x, y = rand((n13,), imf * q), rand((n13,), imf * q)
            add(f"mult_mod imf={imf} 2^13 {bits}-bit", "K4",
                lambda x=x, y=y, q=q, imf=imf: port.eltwise_mult_mod(
                    x, y, q, imf),
                lambda x=x, y=y, q=q, imf=imf: plain64.mult_mod(x, y, q, imf))
        for imf in (q, 2, 4):
            x = rand((n13,), 1 << 64 if imf == q else imf * q)
            add(f"reduce_mod imf={'q' if imf == q else imf} 2^13 {bits}-bit",
                "K8.reduce",
                lambda x=x, q=q, imf=imf: port.eltwise_reduce_mod(x, q, imf,
                                                                  1),
                lambda x=x, q=q, imf=imf: plain64.reduce_mod(x, q, imf, 1))
    q = top_modulus(nt, 59, n14)
    fma_and_cmp((n14,), q, "2^14 59-bit")
    x = rand((n14,), 2 * q)
    add("reduce_mod 2->1 2^14 59-bit", "K8.reduce",
        lambda x=x, q=q: port.eltwise_reduce_mod(x, q, 2, 1),
        lambda x=x, q=q: plain64.reduce_mod(x, q, 2, 1))
    for i, q in enumerate(nt.generate_primes(8, 59, True, ntt_size=n14)):
        fma_and_cmp((n14,), q, f"2^14 59-bit, prime {i} of 8", imfs=(1,))
    montgomery((n13,), XEON_MONT_MODULUS, "2^13 47-bit (Xeon modulus)")
    # Every op at 2^22 elements, 64-bit and single-word.
    q60 = top_modulus(nt, 60, BIG[-1])
    eltwise_ops(BIG, q60, "2^22 60-bit")
    montgomery(BIG, q60, "2^22 60-bit")
    eltwise_ops(BIG, top_modulus(nt, 29, BIG[-1]), "2^22 29-bit")
    # The composites.
    q4 = nt.generate_primes(4, 50, True, ntt_size=n14)
    for n, basis in ((n14, q4), (BIG[-1], rns_moduli)):
        x, y = (torch.stack([torch.stack([rand((n,), q) for q in basis])
                             for _ in range(2)]) for _ in range(2))
        add(f"dyadic_multiply 2^{n.bit_length() - 1} x {len(basis)} primes",
            "K9", lambda x=x, y=y, basis=basis: port.dyadic_multiply(
                x, y, basis),
            lambda x=x, y=y, basis=basis: dyadic.dyadic_plain(
                x[None], y[None], dyadic.row_constants(tuple(basis), dev)))
    c1, c2 = (torch.stack([torch.stack([torch.stack(
        [rand((n14,), q) for q in q4]) for _ in range(2)])
        for _ in range(LR_WEIGHTS)]) for _ in range(2))
    add(f"lr_mat_vec_mult 2^14 x 4 primes x {LR_WEIGHTS} weights", "K9",
        lambda: port.lr_mat_vec_mult(c1, c2, q4),
        lambda: dyadic.dyadic_plain(c1, c2, dyadic.row_constants(tuple(q4),
                                                                 dev)))
    for n, ds in KS_SHAPES:
        args = key_switch_inputs(rng, n, (49,) * (ds + 1), 2, dev, nt,
                                 to_tensor)
        result, t, keys, moduli, msf = args
        add(f"key_switch N=2^{n.bit_length() - 1} ds={ds}", "K11",
            lambda result=result, t=t, keys=keys, moduli=moduli, msf=msf, n=n,
            ds=ds: port.key_switch(result, t, n, ds, ds + 1, ds + 1, 2,
                                   moduli, keys, msf),
            lambda result=result, t=t, keys=keys, moduli=moduli, msf=msf, n=n,
            ds=ds: ks.key_switch_plain(result, t, n, ds, ds + 1, ds + 1, 2,
                                       moduli, keys, msf))
    return cases


# The transforms of one key switch (`experimental.key_switch.pipeline`)
# as (label, rows, batch, forward, imf, omf): rows = ds is a call stacked
# over the ds decomposition primes, rows = 1 the key prime's call.
def key_switch_transforms(ds):
    return (("inv", ds, 1, False, 2, 1), ("fwd", ds, ds - 1, True, 4, 4),
            ("key.fwd", 1, ds, True, 4, 4), ("key.inv", 1, 2, False, 2, 2),
            ("md.fwd", ds, 2, True, 4, 4))


def transform_launches(rns, sms, dev, n, rows, batch, stacked=True):
    """{kernel: launches} of one 64-bit exact transform of (rows, batch, n)
    (stacked over `rows` primes, or one prime's), under the cluster form's
    rule (`rns.cluster_for`): K1 (.rns) or K1.rns.cl up to 2^14; above, K5
    (.rns, the column form) and K6 (.rns) or K6.rns.cl."""
    shards = max(1, n >> 14)
    log_n = min(n.bit_length() - 1, 14)
    clustered = n >= 1 << 12 and rns.cluster_for(
        log_n, rows * batch * shards, sms, dev) > 1
    sfx = ".rns" if stacked else ""
    if n <= 1 << 14:
        return {"K1.rns.cl" if clustered else "K1" + sfx: 1}
    return {"K5" + sfx: 1, "K6.rns.cl" if clustered else "K6" + sfx: 1}


def key_switch_launches(rns, sms, dev, n, ds):
    """{kernel: launches} of one key switch (kc 2) at (n, ds > 1, distinct
    primes): its transforms (`key_switch_transforms`) under the cluster
    rule, the base conversions, K10, K11 twice. Above 2^14 the block's
    base conversion rides in its cross pass (K5.rns.conv, no
    K8.reduce.rows)."""
    out = collections.Counter({"K8.reduce": 1, "K10": 1, "K11": 2})
    fused = n > 1 << 14
    if not fused:
        out["K8.reduce.rows"] = 1
    for label, rows, batch, _, _, _ in key_switch_transforms(ds):
        launches = transform_launches(rns, sms, dev, n, rows, batch,
                                      rows > 1)
        if fused and label == "fwd":
            launches["K5.rns.conv"] = launches.pop("K5.rns")
        out.update(launches)
    return dict(out)


def key_switch_calls(n, ds, moduli, rand, get_plan, cuda_ntt, rns):
    """[(label, x, plan, fn)] of one key switch's transforms
    (`key_switch_transforms`: the same calls, shapes and lazy ranges as
    `experimental.key_switch.pipeline`, on random inputs): the target's ds
    inverses and the (ds, ds - 1, n) block of base-converted targets at
    (4, 4), each one stacked call over the ds decomposition primes
    (`rns`), the key prime's forward of the ds converted targets and its
    inverse, and the mod-down's ds forwards, one stacked call; fn() runs
    the call on x (a (rows, batch, n) block or the key prime's (batch, n)),
    plan its RnsPlan or the key prime's plan. Through an earlier tree's
    `rns`, whose stacked calls loop over the primes, it runs that tree's
    transforms."""
    import torch
    rplan = rns.get_rns_plan(n, moduli[:ds])
    key_plan = get_plan(n, moduli[-1])
    calls = []
    for label, rows, batch, forward, imf, omf in key_switch_transforms(ds):
        if rows == 1:
            x = rand((batch, n), imf * moduli[-1])
            fn = cuda_ntt.fwd_ntt if forward else cuda_ntt.inv_ntt
            plan = key_plan
        else:
            x = torch.stack([rand((batch, n), imf * q) for q in moduli[:ds]])
            fn = rns.fwd_ntt_rns if forward else rns.inv_ntt_rns
            plan = rplan
        calls.append((label, x, plan, lambda fn=fn, x=x, plan=plan, imf=imf,
                      omf=omf: fn(x, plan, imf, omf)))
    return calls


def key_switch_ntts(n, ds, moduli, rand, get_plan, cuda_ntt, rns):
    """A function that runs the transforms of one key switch
    (`key_switch_calls`), one after the other."""
    calls = [fn for _, _, _, fn in key_switch_calls(n, ds, moduli, rand,
                                                    get_plan, cuda_ntt, rns)]

    def run():
        for fn in calls:
            fn()
    return run


def one_cta_grid(n, rows, batch):
    """The CTAs of the one-CTA launches of a transform of (rows, batch, n):
    {kernel: CTAs}, K1 (or K1.rns) up to 2^14; above, K5's column form (a
    thread a column, 128 a CTA) and K6's one 2^14 shard a CTA."""
    if n <= 1 << 14:
        return {"K1": rows * batch}
    return {"K5": rows * -(-batch * (1 << 14) // 128),
            "K6": rows * batch * (n >> 14)}


def split_variant(x, plan, forward, omf, log_l, hier, rns, torch_ntt):
    """The transform of x cut at L = 2^log_l with the kernels a tree
    already has: K5 (K5.rns for a stacked block, `rns`'s C entry) on the
    (D, L) view for the stages of stride >= L, D = N / L, and K6's local
    pass with a shard base (`hier.local_launch`, a prime at a time for a
    stacked block) for those below. x: a (batch, n) block under a plan, or
    a (k, batch, n) one under an RnsPlan."""
    import torch
    n = x.shape[-1]
    log_d = n.bit_length() - 1 - log_l
    stacked = hasattr(plan, "plans")

    def local(v):
        if not stacked:
            return hier.local_launch(v, plan, forward, omf, log_l, log_d, 0,
                                     log_d)
        return torch.stack([hier.local_launch(v[i], p, forward, omf, log_l,
                                              log_d, 0, log_d)
                            for i, p in enumerate(plan.plans)])

    def cross(v):
        if not stacked:
            return hier.cross(v.reshape(*v.shape[:-1], 1 << log_d, 1 << log_l),
                              plan, forward, omf).reshape(v.shape)
        rows = plan.descriptors(v.device)
        batch = v[0].numel() // n
        if forward:
            return rns._launch("cross_rns", "hexl_cross_fwd_rns",
                               rns._CROSS_FWD_ARGS, "K5.rns", v, rows, log_d,
                               log_l, batch, 0)
        return rns._launch("cross_rns", "hexl_cross_inv_rns",
                           rns._CROSS_INV_ARGS, "K5.rns", v, rows, log_d,
                           log_l, batch, torch_ntt.root_index(n, n >> log_d),
                           omf, 0)

    return local(cross(x)) if forward else cross(local(x))


# The graft pipeline of the first path and the seventh path's trace:
# (N, q bits, batch), forward at OMF 4 twice, mult_mod at IMF 4, inverse.
GRAFT = (1 << 12, 50, 2)
# The cuts of the split variant: L from 2^10 to 2^13 below N.
SPLIT_LOG_LS = (10, 11, 12, 13)


def ks_runs(rng, dev, nt, get_plan, cuda_ntt, hier, rns, torch_ntt,
            to_tensor, key_switch, mult_mod) -> dict:
    """{row: (fn, CTAs)} of the key switch at every KS_SHAPES entry and
    the graft pipeline, launch by launch: "KS.n14.ds3" the key switch (kc
    2, 49-bit), "KS.n14.ds3.ntts" its transforms, "KS.n14.ds3.inv" ..
    each transform (`key_switch_transforms`) with its one-CTA grid
    (`one_cta_grid`), and ".L11" .. each transform's split variant at L =
    2^11 .. (`split_variant`); "graft", "graft.fwd", "graft.inv" and their
    split variants. Written against the wrappers' signatures, which the
    parent tree of an A/B shares."""
    import numpy as np
    import torch

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    runs = {}

    def add_splits(row, x, plan, forward, omf):
        n = x.shape[-1]
        for log_l in SPLIT_LOG_LS:
            if 1 << log_l < n and n >> log_l <= 64:
                runs[f"{row}.L{log_l}"] = (
                    lambda x=x, plan=plan, log_l=log_l: split_variant(
                        x, plan, forward, omf, log_l, hier, rns, torch_ntt),
                    {"K6": x.numel() >> log_l})

    for n, ds in KS_SHAPES:
        tag = f"KS.n{n.bit_length() - 1}.ds{ds}"
        result, t, keys, moduli, msf = key_switch_inputs(
            rng, n, (49,) * (ds + 1), 2, dev, nt, to_tensor)
        runs[tag] = (lambda result=result, t=t, n=n, ds=ds, moduli=moduli,
                     keys=keys, msf=msf: key_switch(
                         result, t, n, ds, ds + 1, ds + 1, 2, moduli, keys,
                         msf), None)
        runs[tag + ".ntts"] = (key_switch_ntts(n, ds, moduli, rand, get_plan,
                                               cuda_ntt, rns), None)
        specs = key_switch_transforms(ds)
        for (label, x, plan, fn), spec in zip(
                key_switch_calls(n, ds, moduli, rand, get_plan, cuda_ntt,
                                 rns), specs):
            _, rows, batch, forward, _, omf = spec
            runs[f"{tag}.{label}"] = (fn, one_cta_grid(n, rows, batch))
            add_splits(f"{tag}.{label}", x, plan, forward, omf)
    n, bits, batch = GRAFT
    plan = get_plan(n, nt.generate_primes(1, bits, True, ntt_size=n)[0])
    ga, gb = rand((batch, n), plan.q), rand((batch, n), plan.q)
    gi = rand((batch, n), plan.q)
    runs["graft"] = (lambda: cuda_ntt.inv_ntt(mult_mod(
        cuda_ntt.fwd_ntt(ga, plan, 1, 4), cuda_ntt.fwd_ntt(gb, plan, 1, 4),
        plan.q, 4), plan), None)
    runs["graft.fwd"] = (lambda: cuda_ntt.fwd_ntt(ga, plan, 1, 4),
                         one_cta_grid(n, 1, batch))
    runs["graft.inv"] = (lambda: cuda_ntt.inv_ntt(gi, plan),
                         one_cta_grid(n, 1, batch))
    add_splits("graft.fwd", ga, plan, True, 4)
    add_splits("graft.inv", gi, plan, False, 1)
    return runs


def ks_times(root: pathlib.Path) -> int:
    """`--ks-times ROOT`: build the port at ROOT and print the device ms
    of each row of `ks_runs` (median [min, max] of 20 graph replays of 20
    calls), with the one-CTA grid of each transform, and the rows as one
    JSON line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    log(nvidia_smi("name,power.limit"))
    import_port(root)
    from hexl_tpu_torch import _build, key_switch, nt
    from hexl_tpu_torch.eltwise import ops
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import cuda_ntt, get_plan, hier, rns, torch_ntt
    _build.build_all()
    runs = ks_runs(np.random.default_rng(SEED), torch.device("cuda", 0), nt,
                   get_plan, cuda_ntt, hier, rns, torch_ntt, to_tensor,
                   key_switch, ops.mult_mod)
    out = {}
    for row, (fn, ctas) in runs.items():
        _build.reset_launches()
        fn()
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        v = graph_times(fn, 20)
        out[row] = {"ms": statistics.median(v), "min": min(v), "max": max(v),
                    "ctas": ctas, "launches": launches}
        log(f"ks {row}: {out[row]['ms']:.4f} ms [{min(v):.4f}, "
            f"{max(v):.4f}]; one-CTA grid {ctas}; launches {launches}")
    log(nvidia_smi("name,power.limit"))
    print(json.dumps(out))
    return 0


FFT_PRECISIONS = ("f64", "single", "double_float")
FFT_N = 1 << 14            # CKKS at N = 2^15: 2^14 slots
FFT_BATCH = 64
FFT_SCALAR = 2.0 ** 40     # the CKKS scale of the fourth path
FIXED_POINT_BITS = 20      # the decode's integers carry 2^20 x the scale
XEON_FFT_SCALAR = 2.0 ** 30  # the Xeon rows fuse a 2^-30 scale
# Floating-point operations of each step of the FFT-like, counted from the
# arithmetic, negations free: "mul" the butterfly's product by an already
# split twiddle (f64 and single: 4 multiplies, 2 adds; double-float:
# df32.py's cdf_mul_ps, 82), "add" a complex add or subtract (2; 22),
# "split" presplitting one twiddle, once per stage as the flat walks do
# (0; the two 4097-splits of re.hi and im.hi, 8), "scale" a complex value
# times a real scalar (2; two df_mul, 48) and "mul_full" the inverse's
# scaled final product (6; cdf_mul, 118). Non-tensor-core lanes per SM of
# an H100: 64 FP64, 128 FP32.
_COMPLEX_COST = {"mul": 6, "add": 2, "split": 0, "scale": 2, "mul_full": 6}
FFT_COST = {"f64": _COMPLEX_COST, "single": _COMPLEX_COST,
            "double_float": {"mul": 82, "add": 22, "split": 8, "scale": 48,
                             "mul_full": 118}}
FP64_LANES_PER_SM = 64
FP32_LANES_PER_SM = 128


def fft_pass_ops(precision, n, batch, block_n, forward, cross, scaled):
    """The floating-point operations one pass of the split FFT-like (n >
    block_n) needs on `batch` transforms. The stage with m twiddle blocks
    (m from 1 to n/2; the cross pass has those with m < n/block_n, the
    block pass the others) does batch * n/2 butterflies, a product and a
    complex add and subtract each, and splits its m twiddles once. With a
    scalar, the forward's last stage (m = n/2, in the block pass) scales
    its xs and its twiddles; the inverse's final stage (m = 1, in the
    cross pass) scales the sum and its one twiddle and takes the full
    product."""
    c = FFT_COST[precision]
    bfly = batch * n // 2
    d = n // block_n
    ms = [1 << k for k in range(n.bit_length() - 1)
          if ((1 << k) < d) == cross]
    ops = sum(bfly * (c["mul"] + 2 * c["add"]) + m * c["split"] for m in ms)
    if scaled and forward and not cross:
        ops += (bfly + n // 2) * c["scale"]
    if scaled and not forward and cross:
        ops += (bfly * (c["scale"] + c["mul_full"] - c["mul"])
                + c["scale"] - c["split"])
    return ops


def fft_value(rng, shape, precision, dev):
    """Random complex values of a precision's form on dev: a complex128 or
    complex64 tensor, or a CDF of float32 planes."""
    import torch
    from hexl_tpu_torch.experimental import df32
    z = torch.from_numpy(rng.normal(size=shape) + 1j * rng.normal(size=shape))
    if precision == "double_float":
        return df32.cdf_from_complex128(z, dev)
    return z.to(dev, torch.complex64 if precision == "single"
                else torch.complex128)


def fft_kernel_cases(rng, dev, FFTLike, cuda_fft):
    """(kernel, precision, what, kernel's output, plain output) for K12 and
    K13 against the plain walks on the card: every precision, every n from
    16 to 2^13 (K12 alone: the radix walk at batches 1 and 3, one
    transform per CTA; batch 300 up to 2^12, several per CTA on the stage
    walk below cuda_fft.PACK_BELOW, one per CTA from it on) and from 2^14
    to 2^17 (the split: K13 and K12 alone, and the whole transform),
    forward and inverse, with and without a scalar."""
    for precision in FFT_PRECISIONS:
        k12 = cuda_fft.kernel_name("K12", precision)
        k13 = cuda_fft.kernel_name("K13", precision)
        for n in (1 << k for k in range(4, 18)):
            split = n > cuda_fft.BLOCK_N
            for scalar in (None, FFT_SCALAR):
                fft = FFTLike(n, scalar, precision=precision, device=dev)
                tables = fft.tables(dev)
                for batch in ((2,) if split else
                              (1, 3, 300) if n <= 1 << 12 else (1, 3)):
                    v = fft_value(rng, (batch, n), precision, dev)
                    for forward in (True, False):
                        s = fft.fused_scale(forward)
                        tab = tables[0 if forward else 1]
                        what = (f"{precision} n={n} batch={batch} "
                                f"scalar={scalar} "
                                f"{'fwd' if forward else 'inv'}")
                        args = (v, tab, s, precision, forward)
                        if split:
                            yield (k13, precision, "cross " + what,
                                   cuda_fft.cross(*args),
                                   cuda_fft.cross_plain(*args))
                            yield (k12, precision, "block " + what,
                                   cuda_fft.block(*args),
                                   cuda_fft.block_plain(*args))
                        whole = cuda_fft.forward if forward else \
                            cuda_fft.inverse
                        yield (k13 if split and not forward else k12,
                               precision, "whole " + what,
                               whole(v, tab, s, precision),
                               cuda_fft.walk_plain(*args))


def mxu_kernel_checks(rng, dev, nt, get_mxu_plan, mxu_ntt, to_tensor,
                      compare) -> int:
    """K14 and K15 against the plain folds on the same int32 planes, in
    every pass of the four-step NTT: N in {2^8, 2^10, 2^14, 2^17}, q just
    above 2^29, 2^49, 2^52 (a 53-bit q, the object path of the plan) and
    2^60, and the largest prime below 2^62, over the IMF/OMF matrix.
    Returns the number of checks."""
    import numpy as np
    checks = 0

    def checked(kernel, fold, plain, what):
        def run(planes, *args):
            nonlocal checks
            got = fold(planes, *args)
            compare(kernel, got, plain(planes, *args), what)
            checks += 1
            return got
        return run

    for n in (1 << 8, 1 << 10, 1 << 14, 1 << 17):
        for q_bits in (29, 49, 52, 60, 62):
            q = top_modulus(nt, q_bits, n)
            plan = get_mxu_plan(n, q)
            for forward, imfs, omfs in ((True, (1, 2, 4), (1, 4)),
                                        (False, (1, 2), (1, 2))):
                for imf in imfs:
                    x = to_tensor(rng.integers(0, imf * q, size=(3, n),
                                               dtype=np.uint64), dev)
                    for omf in omfs:
                        what = (f"n={n} q_bits={q_bits} "
                                f"{'fwd' if forward else 'inv'} imf={imf} "
                                f"omf={omf}")
                        mxu_ntt._passes(
                            x, plan, forward, omf,
                            checked("K14", mxu_ntt.fold_twiddle,
                                    mxu_ntt.fold_twiddle_plain, what),
                            checked("K15", mxu_ntt.fold_final,
                                    mxu_ntt.fold_final_plain, what))
    return checks


PARALLEL_Q_BITS = (29, 30, 50, 60, 61)


def parallel_kernel_checks(rng, dev, nt, get_plan, hier, shard, pipeline,
                           to_tensor, compare) -> int:
    """The kernels of the parallel layer against their plain versions, bit
    for bit, for q just above 2^29 (q < 2^30 goes through the 64-bit walk
    in this layer), 2^30, 2^50, 2^60 and 2^61: K5 with a column stride on DistNTT's
    exchanged (batch, D, lc) blocks for D in {2, 4, 8, 16, 128} (two
    launches for 128) and lc from
    256/D up to 2^14 (N = D^2 lc <= 2^20), and on a slice of the chunk
    axis, forward and inverse at both OMFs; K6 with a shard base at the
    first, a middle and the last position for L from 2^10 to 2^14, and at
    L = 2^15 and 2^16 (K5 on the intra-shard stages, then K6 on 2^14
    sub-shards), a modulus of each size in turn over the K5 and K6 cases;
    K6 launched with a shard base and a period (log_sub) for shards of
    2^11 to 2^14, in both words and the approximate schemes;
    K16 at every stage of N in {2^10, 2^14, 2^17} for every size, the
    fused final stage at OMF 1 and 2 (forward 1 and 4). Returns the
    number of checks."""
    import numpy as np
    checks = 0

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    cases = 0
    for d in (2, 4, 8, 16, 128):
        lc = max(1, 256 // d)
        while lc <= (1 << 14) and d * d * lc <= (1 << 20):
            n = d * d * lc
            q_bits = PARALLEL_Q_BITS[cases % len(PARALLEL_Q_BITS)]
            cases += 1
            q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
            plan = get_plan(n, q)
            for batch, width in ((3, lc), (2, max(1, lc // 4))):
                what = (f"D={d} lc={lc} width={width} batch={batch} "
                        f"q_bits={q_bits}")
                x = rand((batch, d, width), 4 * q)
                compare("K5.col", hier.cross(x, plan, True),
                        hier.cross_fwd_plain(x, plan), f"cross fwd {what}")
                x = rand((batch, d, width), 2 * q)
                for omf in (1, 2):
                    compare("K5.col", hier.cross(x, plan, False, omf),
                            hier.cross_inv_plain(x, plan, omf),
                            f"cross inv {what} omf={omf}")
                checks += 3
            lc *= 2
    for log_l in range(10, 17):
        for d in (2, 8):
            n = d << log_l
            q_bits = PARALLEL_Q_BITS[cases % len(PARALLEL_Q_BITS)]
            cases += 1
            q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
            plan = get_plan(n, q)
            for r in (0, d // 2, d - 1):
                what = f"L=2^{log_l} D={d} r={r} q_bits={q_bits}"
                x = rand((3, n // d), 4 * q)
                for omf in (1, 4):
                    compare("K6.shard", shard.local(x, plan, r, d, True,
                                                    omf),
                            shard.local_fwd_plain(x, plan, r, d, omf),
                            f"local fwd {what} omf={omf}")
                x = rand((3, n // d), 2 * q)
                compare("K6.shard", shard.local(x, plan, r, d, False),
                        shard.local_inv_plain(x, plan, r, d),
                        f"local inv {what}")
                checks += 3
    # K6 launched with a shard base and a period: chunk c is shard
    # base + (c mod 2^log_sub) of 2^log_d, on 5 chunks (a ragged period),
    # for shards of 2^11 .. 2^14, in both words and every lean scheme q
    # allows.
    for log_n in range(11, 15):
        for (log_d, base, log_sub), q_bits in zip(
                ((2, 1, 1), (4, 8, 3), (20 - log_n, 5, 2)), (29, 50, 60)):
            n = 1 << log_n
            q = nt.generate_primes(1, q_bits, True, ntt_size=n << log_d)[0]
            plan = get_plan(n << log_d, q)
            forms = [(64, "exact")] + [(32, "exact")] * (q < 1 << 30) + [
                (64, s_) for s_, bound in (("lean16", 1 << 60),
                                           ("lean8", 1 << 61),
                                           ("approx", 1 << 61)) if q < bound]
            for word, scheme in forms:
                name = ("K6.shard" if (word, scheme) == (64, "exact") else
                        hier.kernel_name("K6", word, scheme))
                what = (f"log_n={log_n} log_d={log_d} base={base} "
                        f"log_sub={log_sub} q_bits={q_bits} word={word} "
                        f"{scheme}")
                args = (log_n, log_d, base, log_sub, word, scheme)
                x = rand((5, n), 4 * q)
                for omf in (1, 4):
                    compare(name, hier.local_launch(x, plan, True, omf, *args),
                            hier.local_launch_plain(x, plan, True, omf, *args),
                            f"shard-base local fwd {what} omf={omf}")
                x = rand((5, n), 2 * q)
                compare(name, hier.local_launch(x, plan, False, 1, *args),
                        hier.local_launch_plain(x, plan, False, 1, *args),
                        f"shard-base local inv {what}")
                checks += 3
    for log_n in (10, 14, 17):
        n = 1 << log_n
        for q_bits in PARALLEL_Q_BITS:
            q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
            plan = get_plan(n, q)
            for k in range(log_n):
                last = k == log_n - 1
                for forward, bound, omfs in (
                        (True, 4 * q, (1, 4) if last else (4,)),
                        (False, 2 * q, (1, 2) if last else (2,))):
                    x = rand((2, n), bound)
                    for omf in omfs:
                        compare("K16", pipeline.stages(x, plan, forward, k,
                                                       k + 1, omf),
                                pipeline.stages_plain(x, plan, forward, k,
                                                      k + 1, omf),
                                f"stage {k} of N=2^{log_n} q_bits={q_bits} "
                                f"{'fwd' if forward else 'inv'} omf={omf}")
                        checks += 1
    return checks


TILE_ARITH = ((60, 64, "exact"), (62, 64, "exact"), (29, 32, "exact"),
              (59, 64, "lean16"), (60, 64, "lean8"), (60, 64, "approx"))


def tile_kernel_checks(rng, dev, nt, get_plan, hier, shard, torch_ntt,
                       to_tensor, compare) -> int:
    """K5 in each of its forms (the rule's pick forced) against the plain
    versions, bit for bit: every D from 2 to 64 at the split's lc = 2^14,
    batches 1, 2 and 3 (the tiled form's last wave of tiles ragged); D =
    128 and 256 through the two-launch form (the within launch with row
    groups and no final stage, as a DistNTT position's exchanged block
    runs it); a position's intra-shard stages above 2^14 (no final stage;
    L = 2^15 and 2^16, then K6); 60-bit and the largest 62-bit q, 29-bit
    q in u32, lean16 and lean8; the forward at its scheme's input range,
    the inverse at OMF 1 and 2. Returns the number of checks."""
    import numpy as np
    checks = 0

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    def prime(bits, n):
        if bits == 62:
            return nt.generate_primes(1, 61, False, ntt_size=n)[0]
        return nt.generate_primes(1, bits, True, ntt_size=n)[0]

    wide = {"exact": (4, 2), "lean16": (16, 8), "lean8": (8, 4),
            "approx": (4, 2)}
    blocks = [((batch, 1 << log_d, hier.LOCAL_N), log_d)
              for log_d in range(1, 7) for batch in (1, 2, 3)]
    blocks += [((2, 128, 1024), 3), ((1, 256, 1024), 4)]
    for shape, log_rows in blocks:
        n = shape[1] * shape[2]
        for q_bits, word, scheme in TILE_ARITH:
            q = prime(q_bits, n)
            plan = get_plan(n, q)
            f_wide, i_wide = wide[scheme]
            xf, xi = rand(shape, f_wide * q), rand(shape, i_wide * q)
            want_f = hier.cross_fwd_plain(xf, plan, word, scheme)
            want_i = {omf: hier.cross_inv_plain(xi, plan, omf, word, scheme)
                      for omf in (1, 2)}
            for form in hier.cross_forms(log_rows, nt.log2_exact(shape[2])):
                name = hier.kernel_name(hier.CROSS_FORMS[form], word, scheme)
                what = (f"{form} form, block {shape}, q_bits={q_bits} "
                        f"word={word} {scheme}")
                with forced_cross_form(hier, form):
                    compare(name, hier.cross(xf, plan, True, 1, word,
                                             scheme), want_f,
                            f"cross fwd {what}")
                    for omf in (1, 2):
                        compare(name, hier.cross(xi, plan, False, omf, word,
                                                 scheme), want_i[omf],
                                f"cross inv {what} omf={omf}")
                checks += 3
    for log_l, d in ((15, 2), (16, 4)):
        n = d << log_l
        q = prime(60, n)
        plan = get_plan(n, q)
        for r in (0, d - 1):
            xf, xi = rand((3, n // d), 4 * q), rand((3, n // d), 2 * q)
            with forced_cross_form(hier, "tile"):
                compare("K5.tile", shard.local(xf, plan, r, d, True, 4),
                        shard.local_fwd_plain(xf, plan, r, d, 4),
                        f"intra-shard fwd L=2^{log_l} D={d} r={r}")
                compare("K5.tile", shard.local(xi, plan, r, d, False),
                        shard.local_inv_plain(xi, plan, r, d),
                        f"intra-shard inv L=2^{log_l} D={d} r={r}")
            checks += 2
    return checks



# The stacked transform's phase-3 cases: k primes of a basis (k = 1, 3 and
# 16), N from 2^6 to 2^20 (K2.rns packs at 2^6, K1.rns from 2^10, the split
# K5.rns/K6.rns above 2^14, the tiled K5 at D = 64), batches whose rows end
# in ragged CTAs (5 polynomials at 2^6 pack as 4 + 1), every IMF/OMF pair,
# exact on a basis of 29- to 62-bit primes (the largest below 2^62 among
# them) and lean16/lean8 on one of 29- to 59-bit primes.
RNS_CHECK_NS = (1 << 6, 1 << 10, 1 << 14, 1 << 15, 1 << 17, 1 << 20)
RNS_CHECK_KS = (1, 3, 16)
RNS_EXACT_BITS = (62, 29, 50, 60, 61, 40, 55, 45)
RNS_LEAN_BITS = (59, 29, 50, 58, 45, 40, 55, 35)


def rns_basis(nt, bits, k, n):
    """k distinct primes = 1 mod 2n, cycling through `bits` ("62" the
    largest prime below 2^62; more primes of a bit length where k asks)."""
    out = []
    for i in range(k):
        b = bits[i % len(bits)]
        count = i // len(bits) + 1
        if b == 62:
            ps = nt.generate_primes(count, 61, False, ntt_size=n)
        else:
            ps = nt.generate_primes(count, b, True, ntt_size=n)
        out.append(ps[count - 1])
    return out


def rns_kernel_checks(rng, dev, nt, rns, hier, ops, torch_kernels, torch_ntt,
                      to_tensor, compare, ns=RNS_CHECK_NS, ks=RNS_CHECK_KS):
    """Every stacked instantiation against the plain stacked walk, bit for
    bit: K1.rns/K2.rns on whole transforms; above 2^14 K5.rns in each form
    (the rule's pick forced) and K6.rns pass by pass against the plain
    passes of each row, and the whole two-launch transform; every IMF/OMF
    pair and scheme (RNS_CHECK_*); K4.rows at IMF 1, 2 and 4 and
    K8.reduce.rows over any u64, on the (k, 3, 2^12 + 1) blocks of mixed
    bases. Returns the number of checks."""
    import numpy as np
    import torch
    checks = 0
    wide = {"exact": (4, 2), "lean16": (16, 8), "lean8": (8, 4),
            "approx": (4, 2)}

    def rand_rows(moduli, shape, factor):
        return torch.stack([to_tensor(rng.integers(
            0, factor * q, size=shape, dtype=np.uint64), dev)
            for q in moduli])

    def stacked_plain(fn, x, plans, *args):
        return torch.stack([fn(x[i], p, *args) for i, p in enumerate(plans)])

    for n in ns:
        log_d = max(0, n.bit_length() - 1 - hier.LOG_LOCAL)
        for k in ks:
            batches = (1, 2, 5) if n <= hier.LOCAL_N else (1, 3)
            if n == 1 << 20 and k == 16:
                batches = (1,)
            for scheme, bits in (("exact", RNS_EXACT_BITS),
                                 ("lean16", RNS_LEAN_BITS),
                                 ("lean8", RNS_LEAN_BITS)):
                if n == 1 << 20 and k == 16 and scheme != "exact":
                    continue
                moduli = rns_basis(nt, bits, k, n)
                rplan = rns.get_rns_plan(n, moduli)
                f_wide, i_wide = wide[scheme]
                for batch in batches:
                    what = (f"n={n} k={k} batch={batch} {scheme}")
                    shape = (batch, n)
                    if n <= hier.LOCAL_N:
                        name = hier.kernel_name(
                            "K2.rns" if n < 256 and batch > 1 else "K1.rns",
                            64, scheme)
                        for imf in (1, 2, 4):
                            x = rand_rows(moduli, shape, imf)
                            for omf in (1, 4):
                                compare(name, rns.fwd_ntt_rns(
                                    x, rplan, imf, omf, scheme),
                                    rns.fwd_ntt_rns_plain(
                                        x, rplan, imf, omf, scheme),
                                    f"fwd_ntt_rns {what} imf={imf} "
                                    f"omf={omf}")
                                checks += 1
                        for imf in (1, 2):
                            x = rand_rows(moduli, shape, imf)
                            for omf in (1, 2):
                                compare(name, rns.inv_ntt_rns(
                                    x, rplan, imf, omf, scheme),
                                    rns.inv_ntt_rns_plain(
                                        x, rplan, imf, omf, scheme),
                                    f"inv_ntt_rns {what} imf={imf} "
                                    f"omf={omf}")
                                checks += 1
                        continue
                    # The split, pass by pass: K5.rns in each form, K6.rns.
                    rows = rplan.descriptors(dev)
                    blocks = (k, batch, 1 << log_d, hier.LOCAL_N)
                    k6 = hier.kernel_name("K6.rns", 64, scheme)
                    xf = rand_rows(moduli, shape, f_wide)
                    xi = rand_rows(moduli, shape, i_wide)
                    want_cf = stacked_plain(
                        hier.cross_fwd_plain, xf.view(blocks), rplan.plans,
                        64, scheme)
                    want_ci = {omf: stacked_plain(
                        hier.cross_inv_plain, xi.view(blocks), rplan.plans,
                        omf, 64, scheme) for omf in (1, 2)}
                    for form in hier.cross_forms(log_d, hier.LOG_LOCAL):
                        k5 = hier.kernel_name(
                            hier.CROSS_FORMS[form] + ".rns", 64, scheme)
                        with forced_cross_form(hier, form):
                            compare(k5, rns._cross(xf, rows, rplan, batch,
                                                   True, 1, scheme),
                                    want_cf.view(xf.shape),
                                    f"K5.rns fwd {form} {what}")
                            for omf in (1, 2):
                                compare(k5, rns._cross(
                                    xi, rows, rplan, batch, False, omf,
                                    scheme), want_ci[omf].view(xi.shape),
                                    f"K5.rns inv {form} {what} omf={omf}")
                        checks += 3
                    for omf in (1, 4):
                        compare(k6, rns._local(xf, rows, rplan, batch, True,
                                               omf, scheme),
                                stacked_plain(hier.local_fwd_plain, xf,
                                              rplan.plans, omf, 64, scheme),
                                f"K6.rns fwd {what} omf={omf}")
                    compare(k6, rns._local(xi, rows, rplan, batch, False, 1,
                                           scheme),
                            stacked_plain(hier.local_inv_plain, xi,
                                          rplan.plans, 64, scheme),
                            f"K6.rns inv {what}")
                    checks += 3
                    # The whole transform through the public functions, in
                    # the rule's form: every IMF/OMF pair.
                    k5 = hier.kernel_name(hier.CROSS_FORMS[hier.cross_form(
                        log_d, hier.LOG_LOCAL, k * batch, 64, scheme)]
                        + ".rns", 64, scheme)
                    for imf in (1, 2, 4):
                        x = rand_rows(moduli, shape, imf)
                        for omf in (1, 4):
                            compare(k6, rns.fwd_ntt_rns(x, rplan, imf, omf,
                                                        scheme),
                                    rns.fwd_ntt_rns_plain(x, rplan, imf, omf,
                                                          scheme),
                                    f"fwd_ntt_rns {what} imf={imf} omf={omf}")
                            checks += 1
                    for imf in (1, 2):
                        x = rand_rows(moduli, shape, imf)
                        for omf in (1, 2):
                            compare(k5, rns.inv_ntt_rns(x, rplan, imf, omf,
                                                        scheme),
                                    rns.inv_ntt_rns_plain(x, rplan, imf, omf,
                                                          scheme),
                                    f"inv_ntt_rns {what} imf={imf} omf={omf}")
                            checks += 1
    # K4.rows and K8.reduce.rows over mixed bases, ragged rows.
    for k in ks:
        moduli = rns_basis(nt, RNS_EXACT_BITS, k, 1 << 12)
        consts = ops.row_constants(tuple(moduli), dev)
        shape = (3, (1 << 12) + 1)
        for imf in (1, 2, 4):
            a, b = rand_rows(moduli, shape, imf), rand_rows(moduli, shape, imf)
            compare("K4.rows", ops.mult_mod_rows(a, b, moduli, imf),
                    torch_kernels.mult_mod_rows(a, b, consts, imf),
                    f"mult_mod_rows k={k} imf={imf}")
            checks += 1
        x = to_tensor(rng.integers(0, 1 << 64, size=(k,) + shape,
                                   dtype=np.uint64), dev)
        for omf in (1, 2):
            compare("K8.reduce.rows", ops.reduce_mod_rows(x, moduli, omf),
                    torch_kernels.reduce_mod_rows(x, consts, omf),
                    f"reduce_mod_rows k={k} omf={omf}")
            checks += 1
    return checks

# The cluster form (K1.rns.cl, K6.rns.cl, K6.shard.cl;
# csrc/ntt_cluster.cuh): its instantiations, the forward, the whole
# transform's inverse and the shard's inverse at each (C, chunk) it takes
# (11 each: C = 2, 4, 8 at three chunks, 16 at two constant shapes).
CLUSTER_INSTANTIATION = re.compile(r"rns_cluster_(fwd|inv)_kernel")
CLUSTER_INSTANTIATIONS = 11 + 11 + 11
CLUSTER_SIZES = (2, 4, 8, 16)
# Its phase-3 cases: every IMF/OMF pair of each direction.
CLUSTER_CHECK_PAIRS = ((True, 1, 1), (True, 2, 4), (True, 4, 4),
                       (True, 4, 1), (False, 1, 1), (False, 2, 2),
                       (False, 2, 1), (False, 1, 2))


@contextlib.contextmanager
def forced_clusters(rns, clusters):
    """Every launch takes clusters of `clusters` CTAs (1: the one-CTA
    form) instead of `rns.cluster_for`'s pick."""
    choose = rns.cluster_for
    rns.cluster_for = lambda *args: clusters
    try:
        yield
    finally:
        rns.cluster_for = choose


def cluster_kernel_checks(rng, dev, nt, rns, cuda_ntt, get_plan, torch_ntt,
                          to_tensor, compare, launches):
    """K1.rns.cl and K6.rns.cl at every C and degree `rns.cluster_for` can
    pick, against the plain cluster walk, bit for bit: the stacked
    transform of k = 1 and 3 primes of mixed bit lengths (batch 3) at N =
    2^12 .. 2^14, and of 1 and 2 primes at N = 2^15 .. 2^20 (the shards of
    the split), every IMF/OMF pair; and the routed one-prime calls of
    `cuda_ntt` (and through it `hier`'s local pass) at N = 2^12 .. 2^16,
    batches 1 and 3, against the plain flat walk. Each call must launch
    its cluster kernel once (`launches`, the launch counter). Returns the
    number of checks."""
    import numpy as np
    import torch

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    def launched(kernel, what):
        if launches.get(kernel, 0) != 1:
            raise AssertionError(f"{what} launched {dict(launches)}, not "
                                 f"one {kernel}")

    checks = 0
    for c in CLUSTER_SIZES:
        with forced_clusters(rns, c):
            for log_n in range(12, 21):
                n = 1 << log_n
                kernel = "K1.rns.cl" if log_n <= 14 else "K6.rns.cl"
                for k, batch in ((1, 3), (3, 3)) if log_n <= 14 else \
                        ((1, 1), (2, 1)):
                    moduli = rns_basis(nt, RNS_EXACT_BITS, k, n)
                    rplan = rns.get_rns_plan(n, moduli)
                    for forward, imf, omf in CLUSTER_CHECK_PAIRS:
                        x = torch.stack([rand((batch, n), imf * q)
                                         for q in moduli])
                        launches.clear()
                        fn = rns.fwd_ntt_rns if forward else rns.inv_ntt_rns
                        got = fn(x, rplan, imf, omf)
                        what = (f"{kernel} C={c} N=2^{log_n} k={k} "
                                f"batch={batch} {'fwd' if forward else 'inv'}"
                                f" imf={imf} omf={omf}")
                        launched(kernel, what)
                        plain = (rns.fwd_ntt_rns_cluster_plain if forward
                                 else rns.inv_ntt_rns_cluster_plain)
                        compare(kernel, got, plain(x, rplan, c, imf, omf),
                                what)
                        checks += 1
            for log_n in range(12, 17):
                n = 1 << log_n
                kernel = "K1.rns.cl" if log_n <= 14 else "K6.rns.cl"
                plan = get_plan(n, rns_basis(nt, (60,), 1, n)[0])
                for batch in (1, 3):
                    for forward, imf, omf in CLUSTER_CHECK_PAIRS:
                        x = rand((batch, n), imf * plan.q)
                        launches.clear()
                        fn = cuda_ntt.fwd_ntt if forward else cuda_ntt.inv_ntt
                        got = fn(x, plan, imf, omf)
                        what = (f"one prime {kernel} C={c} N=2^{log_n} "
                                f"batch={batch} {'fwd' if forward else 'inv'}"
                                f" imf={imf} omf={omf}")
                        launched(kernel, what)
                        plain = (torch_ntt.fwd_ntt if forward
                                 else torch_ntt.inv_ntt)
                        compare(kernel, got, plain(x, plan, imf, omf), what)
                        checks += 1
    return checks


# K6.shard.cl's phase-3 cases: shards of 2^12 .. 2^16 (above 2^14 K5 on
# the intra-shard stages, then the cluster on the 2^14 sub-shards) of D =
# 2, 4 and 8 positions, at every position of D <= 4 and the first, a
# middle and the last of 8; batches 1 and 3.
SHARD_CLUSTER_LOG_LS = range(12, 17)
SHARD_CLUSTER_DS = (2, 4, 8)


def shard_cluster_checks(rng, dev, nt, get_plan, rns, shard, to_tensor,
                         compare, launches):
    """K6.shard.cl (a DistNTT position's local pass on a cluster of C CTAs
    a shard or sub-shard) at every C, against its plain version
    (`shard.local_cluster_plain`), bit for bit: `SHARD_CLUSTER_LOG_LS` x
    `SHARD_CLUSTER_DS`, the positions above, the forward at OMF 1 and 4
    and the inverse, a prime of each of PARALLEL_Q_BITS in turn. Each call
    must launch the cluster kernel once (and K5 once above 2^14). Returns
    the number of checks."""
    import numpy as np

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    checks = 0
    for c in CLUSTER_SIZES:
        with forced_clusters(rns, c):
            for log_l in SHARD_CLUSTER_LOG_LS:
                for d in SHARD_CLUSTER_DS:
                    n = d << log_l
                    q_bits = PARALLEL_Q_BITS[checks % len(PARALLEL_Q_BITS)]
                    plan = get_plan(n, nt.generate_primes(
                        1, q_bits, True, ntt_size=n)[0])
                    want = {shard.CLUSTER_NAME: 1}
                    if log_l > 14:
                        want["K5"] = 1
                    for r in range(d) if d <= 4 else (0, d // 2, d - 1):
                        batch = 1 + 2 * (r % 2)
                        what = (f"K6.shard.cl C={c} L=2^{log_l} D={d} r={r} "
                                f"batch={batch} q_bits={q_bits}")
                        for forward, omf in ((True, 1), (True, 4),
                                             (False, 1)):
                            x = rand((batch, n // d),
                                     (4 if forward else 2) * plan.q)
                            launches.clear()
                            got = shard.local(x, plan, r, d, forward, omf)
                            if dict(launches) != want:
                                raise AssertionError(
                                    f"{what} launched {dict(launches)}, not "
                                    f"{want}")
                            compare(shard.CLUSTER_NAME, got,
                                    shard.local_cluster_plain(
                                        x, plan, r, d, forward, omf, c),
                                    f"{what} {'fwd' if forward else 'inv'}"
                                    f" omf={omf}")
                            checks += 1
    return checks


# The instantiations whose registers are checked: the approximate ones
# (mangled names with the scheme argument 1 (lean16), 2 (lean8) or 3
# (approx) after a u64 word), the chain kernels K17/K18, every radix walk
# of K1/K6/K7 (the forward in five forms: four u64 schemes, u32; the
# inverse in ten: with the final stage and without, each in the four u64
# schemes and u32; the u64 forms in seven shapes, the u32 ones in ten,
# ntt_block.cuh with_shape), K2's packed walk (forward and inverse, four
# schemes, R = 8 and R = 2), K3's kernels (poly.cu: the cluster form at
# 2^12-2^14, the one-CTA form at R = 2, R = 8 and 2^10-2^13, each exact
# and approx), and K12's radix walk (fft.cu fft_radix_fwd_kernel and
# fft_radix_inv_kernel: six shapes in complex double and float, three in
# double-float, fft_with_shape), K5's tiled form (cross_tile.cuh), K16
# (stage.cu, exact and approx), every eltwise body (eltwise.cu's streaming
# template, exact and approximate), K10 at every kc it is built for
# (key_switch.cu, exact and approximate) and the approximate
# instantiations of K9 and K11 (dyadic.cu, key_switch.cu: kernels with the
# flag A true).
NEW_INSTANTIATION = re.compile(
    r"chain_kernel|kernelIyLi[123]E|radix_(packed_)?(fwd|inv)_kernel|"
    r"poly_(cluster|cta)_kernel|cross_tile_(fwd|inv)_kernel|stage_kernel|"
    r"eltwise_kernel|mac_flush_parts_kernel|(dyadic|spread|fold)_kernelILb1E")
RADIX_INSTANTIATIONS = (4 + 8) * 7 + (1 + 2) * 10
PACKED_INSTANTIATIONS = 2 * 4 * 2
# K3's two forms (three cluster and six one-CTA kernels) in the four
# schemes: exact, lean16, lean8, approx.
POLY_INSTANTIATIONS = 4 * (3 + 6)
FFT_RADIX_INSTANTIATIONS = 2 * (6 + 6 + 3)
# K5's tiled form (cross_tile.cuh): the forward and the inverse with and
# without the final stage, at every D (2 .. 64), in the four u64 schemes
# and u32; its approximate ones match kernelIyLi[123]E too.
TILE_INSTANTIATIONS = 3 * 6 * 5
# K16 exact and approx; the eltwise bodies: 11 in 64 bits and 6 in the
# single word (add/sub and fma each with and without their vector operand)
# and the 6 approximate ones; K10 at component groups of 1-4, exact and
# approximate.
STAGE_INSTANTIATIONS = 2
ELTWISE_INSTANTIATIONS = 11 + 6 + 6
MAC_INSTANTIATIONS = 2 * 4
COMPOSITE_APPROX_INSTANTIATIONS = 3   # K9, K11's spread and fold
# K5's approximate passes (three schemes, six D, forward and the inverse
# with and without its final stage), the chains, the radix walks, K2, K3,
# K5's tiled form, K16, the eltwise bodies, K10 and the other composites'
# approximate ones.
NEW_INSTANTIATIONS = (3 * 6 * 3 + 2 + 3 + RADIX_INSTANTIATIONS
                      + PACKED_INSTANTIATIONS + POLY_INSTANTIATIONS
                      + FFT_RADIX_INSTANTIATIONS + TILE_INSTANTIATIONS
                      + STAGE_INSTANTIATIONS + ELTWISE_INSTANTIATIONS
                      + MAC_INSTANTIATIONS + COMPOSITE_APPROX_INSTANTIATIONS)
# The stacked instantiations (ntt_rns.cu, cross_rns.cu, eltwise.cu): K1.rns's
# forward and inverse in the three schemes and seven shapes, K6.rns's
# inverse (no final stage) at 2^14 in three, K2.rns forward and inverse in
# three schemes and two radices, K5.rns in both forms forward and inverse
# at every D in three schemes, and the two row ops of K4/K8, exact and
# approximate.
RNS_INSTANTIATION = re.compile(r"_rns_kernel|eltwise_rows_kernel")
RNS_INSTANTIATIONS = (2 * 3 * 7 + 3 + 2 * 3 * 2 + 2 * 2 * 3 * 6 + 2 * 2)
# Moduli of the lean checks: generate_primes(1, b) gives q in (2^b,
# 2^(b+1)); "61" is the largest prime below 2^61, where 8q is just under
# 2^64 (lean8's raw product range).
LEAN_Q_BITS = (49, 59, 60, 61)


def lean_modulus(nt, q_bits: int, n: int) -> int:
    if q_bits == 61:
        return nt.generate_primes(1, 60, False, ntt_size=n)[0]
    return nt.generate_primes(1, q_bits, True, ntt_size=n)[0]


def lean_schemes(torch_ntt, q: int) -> list:
    """Every approximate scheme q allows (lean16 q < 2^60, lean8 < 2^61)."""
    return [s for s, bound in (("lean16", torch_ntt.LEAN16_MAX_Q),
                               ("lean8", torch_ntt.LEAN_APPROX_MAX_Q))
            if q < bound]


def lean_kernel_checks(rng, dev, nt, get_plan, cuda_ntt, hier, torch_ntt,
                       to_tensor, compare, route):
    """K1/K2 (every N from 2 to 2^14) and K5/K6 (every N from 2^15 to
    2^20) in every lean scheme each modulus allows, against the plain lean walk, bit
    for bit, over the IMF/OMF matrix; every fully reduced (OMF 1) lean
    output also against the exact instantiation's. Returns the count."""
    import numpy as np

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    checks = 0
    for log_n in range(1, 15):
        n = 1 << log_n
        batches = ((3, 401) if n in (2, 16, 1024, 4096, 1 << 13, 1 << 14)
                   else (1, 3))
        for q_bits in LEAN_Q_BITS:
            q = lean_modulus(nt, q_bits, n)
            plan = get_plan(n, q)
            for scheme, batch in itertools.product(lean_schemes(torch_ntt, q),
                                                   batches):
                kernel = hier.kernel_name(route(n, batch), 64, scheme)
                what = f"n={n} q_bits={q_bits} {scheme} batch={batch}"
                for imf in (1, 2, 4):
                    x = rand((batch, n), imf * q)
                    for omf in (1, 4):
                        got = cuda_ntt.fwd_ntt(x, plan, imf, omf, 64, scheme)
                        compare(kernel, got, torch_ntt.fwd_ntt(
                            x, plan, imf, omf, 64, scheme),
                            f"fwd {what} imf={imf} omf={omf}")
                        checks += 1
                        if omf == 1:
                            compare(kernel, got, cuda_ntt.fwd_ntt(
                                x, plan, imf, 1),
                                f"fwd {what} imf={imf} OMF 1 == exact")
                            checks += 1
                for imf in (1, 2):
                    x = rand((batch, n), imf * q)
                    for omf in (1, 2):
                        got = cuda_ntt.inv_ntt(x, plan, imf, omf, 64, scheme)
                        compare(kernel, got, torch_ntt.inv_ntt(
                            x, plan, imf, omf, 64, scheme),
                            f"inv {what} imf={imf} omf={omf}")
                        checks += 1
                        if omf == 1:
                            compare(kernel, got, cuda_ntt.inv_ntt(
                                x, plan, imf, 1),
                                f"inv {what} imf={imf} OMF 1 == exact")
                            checks += 1
    for n in (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20):
        for q_bits in LEAN_Q_BITS:
            q = lean_modulus(nt, q_bits, n)
            plan = get_plan(n, q)
            batches = (1, 2) if n == 1 << 20 else (1, 3)
            for scheme, batch in itertools.product(lean_schemes(torch_ntt, q),
                                                   batches):
                blocks = (batch, n // hier.LOCAL_N, hier.LOCAL_N)
                k5 = hier.kernel_name("K5", 64, scheme)
                k6 = hier.kernel_name("K6", 64, scheme)
                what = f"n={n} q_bits={q_bits} {scheme} batch={batch}"
                for imf in (1, 2, 4):
                    x = rand(blocks, imf * q)
                    c = hier.cross(x, plan, True, 1, 64, scheme)
                    compare(k5, c, hier.cross_fwd_plain(x, plan, 64, scheme),
                            f"cross fwd {what} imf={imf}")
                    c = c.view(batch, n)
                    for omf in (1, 4):
                        compare(k6, hier.local(c, plan, True, omf, 64, scheme),
                                hier.local_fwd_plain(c, plan, omf, 64, scheme),
                                f"local fwd {what} imf={imf} omf={omf}")
                    flat = x.view(batch, n)
                    compare(k6, cuda_ntt.fwd_ntt(flat, plan, imf, 1, 64,
                                                 scheme),
                            cuda_ntt.fwd_ntt(flat, plan, imf, 1),
                            f"fwd {what} imf={imf} OMF 1 == exact")
                    checks += 4
                for imf in (1, 2):
                    x = rand((batch, n), imf * q)
                    loc = hier.local(x, plan, False, 1, 64, scheme)
                    compare(k6, loc, hier.local_inv_plain(x, plan, 64, scheme),
                            f"local inv {what} imf={imf}")
                    for omf in (1, 2):
                        compare(k5, hier.cross(loc.view(blocks), plan, False,
                                               omf, 64, scheme),
                                hier.cross_inv_plain(loc.view(blocks), plan,
                                                     omf, 64, scheme),
                                f"cross inv {what} imf={imf} omf={omf}")
                    compare(k5, cuda_ntt.inv_ntt(x, plan, imf, 1, 64, scheme),
                            cuda_ntt.inv_ntt(x, plan, imf, 1),
                            f"inv {what} imf={imf} OMF 1 == exact")
                    checks += 4
    return checks


# Moduli of the approx checks: q just above 2^29, 2^50 and 2^60, and the
# largest prime below 2^61 (the scheme's bound: its raw product lies in
# [0, 8q)).
APPROX_Q_BITS = (29, 50, 60, 61)


def approx_modulus(nt, q_bits: int, n: int) -> int:
    if q_bits == 61:
        return nt.generate_primes(1, 60, False, ntt_size=n)[0]
    return nt.generate_primes(1, q_bits, True, ntt_size=n)[0]


def eltwise_approx_cases(q, size, rng, dev, ops, plain64, nt, to_tensor,
                         offset=0):
    """(what, kernel, kernel's output, plain output) for the five ops with
    an approximate quotient (64-bit) under modulus q, at every IMF/OMF,
    and the two row ops over a basis holding q (rows of size // 2); the
    caller has forced `config.approx_butterflies` on, so the wrappers
    launch their approximate instantiations; every input `placed` at
    `offset`."""
    import numpy as np
    import torch

    def rand(bound, count=size):
        return placed(to_tensor(rng.integers(0, bound - 1, size=count,
                                             dtype=np.uint64, endpoint=True),
                                dev), offset)

    def scalar(lo, hi):
        return int(rng.integers(lo, hi - 1, dtype=np.uint64, endpoint=True))

    for imf in (1, 2, 4):
        if q < 1 << 62:
            x, y = rand(imf * q), rand(imf * q)
            yield (f"mult_mod imf={imf}", ops.kernel_name("mult", 64, True),
                   ops.mult_mod(x, y, q, imf),
                   plain64.mult_mod(x, y, q, imf, True))
    for imf in (1, 2, 4, 8):
        if q < 1 << 61:
            x, z = rand(imf * q), rand(imf * q)
            w = nt.reduce_mod(scalar(0, imf * q), q, imf)
            wp = nt.barrett_factor(w, 64, q)
            for c in (z, None):
                yield (f"fma_mod imf={imf} addend={c is not None}",
                       ops.kernel_name("fma", 64, True),
                       ops.fma_mod(x, w, wp, c, q, imf),
                       plain64.fma_mod_preconned(x, w, wp, c, q, imf, True))
    for imf, omf in ((q, 1), (q, 2), (2, 1), (4, 1), (4, 2), (2, 2)):
        x = rand(1 << 64) if imf == q else rand(imf * q)
        yield (f"reduce_mod imf={'q' if imf == q else imf} omf={omf}",
               ops.kernel_name("reduce", 64, True),
               ops.reduce_mod(x, q, imf, omf),
               plain64.reduce_mod(x, q, imf, omf, True))
    full = rand(1 << 64)
    for cmp in plain64.CMP_NAMES:
        for bound in (scalar(0, 1 << 63), scalar(1 << 63, 1 << 64)):
            f = placed(full.clone(), offset)
            f[:7] = int(np.uint64(bound).view(np.int64))
            diff = scalar(1, q)
            yield (f"cmp_sub_mod {cmp} bound={bound}",
                   ops.kernel_name("cmp_sub", 64, True),
                   ops.cmp_sub_mod(f, q, cmp, bound, diff),
                   plain64.cmp_sub_mod(f, q, cmp, bound, diff, True))
    if q < 1 << 62 and q % 2:
        a = rand(q)
        yield ("montgomery_form_in", ops.kernel_name("mont_in", 64, True),
               ops.montgomery_form_in(a, q),
               plain64.montgomery_form_in(a, q, True))
    if q < 1 << 62:
        moduli = (q, nt.generate_primes(1, 40, True)[0])
        consts = ops.row_constants(moduli, dev)
        rows = size // 2
        for imf in (1, 2, 4):
            x, y = (placed(torch.stack([rand(imf * m, rows) for m in moduli]),
                           offset) for _ in range(2))
            yield (f"mult_mod_rows imf={imf}", "K4.rows.approx",
                   ops.mult_mod_rows(x, y, moduli, imf),
                   plain64.mult_mod_rows(x, y, consts, imf, True))
        x = placed(torch.stack([rand(1 << 64, rows) for _ in moduli]),
                   offset)
        for omf in (1, 2):
            yield (f"reduce_mod_rows omf={omf}", "K8.reduce.rows.approx",
                   ops.reduce_mod_rows(x, moduli, omf),
                   plain64.reduce_mod_rows(x, consts, omf, True))


# The edges of the streaming kernels (K4/K8 and the row ops, K10): counts
# that are no multiple of a thread's 16-byte accesses (EDGE_COUNTS, and
# 2^22 + 3 elements), inputs 8 bytes off a 16-byte boundary, and empty
# tensors; K4/K8 under a 29-bit q (both words) and a 60-bit one (q in
# (2^60, 2^61), 64-bit only), K10 at ds below, at and past a group of its
# four j trips, and at kc of every component group size, a full group of
# four with one left, and two with one left.
EDGE_COUNTS = (1, 3, 5, 1023)
EDGE_Q_BITS = (29, 60)
EDGE_KS_NS = (1, 3, 5, 1023, 1024)
EDGE_KS_DS = (1, 3, 5)
EDGE_KS_KCS = (1, 2, 3, 4, 5, 9)


def eltwise_into(ops, build, out, op, word, a, b=None, c=None, q=0,
                 s=(0, 0, 0), i=(0, 0), approx=False):
    """The C entry hexl_eltwise (as `ops._launch` calls it) into a given
    `out`, which the wrappers always allocate 16-byte aligned: the flat
    kernel's scalar head, where out starts 8 bytes off."""
    fn = build.function("eltwise", "hexl_eltwise", ops._ARGS)
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch_on(a.device, "edge check", fn, a.data_ptr(), ptr(b), ptr(c),
                    out.data_ptr(), a.numel(), ops._OP[op], word,
                    int(approx), q, *s, *i)
    return out


def eltwise_edge_checks(rng, dev, nt, build, ops, plain64, plain32,
                        to_tensor, port_config, compare, q_bits,
                        sizes=EDGE_COUNTS + ((1 << 22) + 3, 0)) -> int:
    """K4/K8 under a q of q_bits: every op (both words where q < 2^30) and
    every approximate instantiation at each of `sizes`, inputs placed at
    offsets 0 and 1; the flat kernel's head (out placed at offset 1,
    through `eltwise_into`) with the inputs at either offset, for
    mult_mod, reduce_mod, fma_mod (approximate) and add_mod (u32). Returns
    the count."""
    import numpy as np
    import torch

    def rand(shape, bound, offset=0):
        return placed(to_tensor(rng.integers(0, bound - 1, size=shape,
                                             dtype=np.uint64, endpoint=True),
                                dev), offset)

    checks = 0
    regime = port_config.approx_butterflies
    q = top_modulus(nt, q_bits)
    for size in sizes:
        for offset in ((0, 1) if size else (0,)):
            tag = f"q_bits={q_bits} count={size} offset={offset}"
            for what, kernel, got, want in eltwise_cases(
                    q, size, rng, dev, ops, plain64, plain32, nt, to_tensor,
                    offset):
                compare(kernel, got, want, f"{what} {tag}")
                checks += 1
            port_config.approx_butterflies = lambda device: True
            try:
                for what, kernel, got, want in eltwise_approx_cases(
                        q, size, rng, dev, ops, plain64, nt, to_tensor,
                        offset):
                    compare(kernel, got, want, f"{what} {tag}")
                    checks += 1
            finally:
                port_config.approx_butterflies = regime
    mu, shift = nt.barrett_mult_constants(q)
    w = nt.reduce_mod(12345, q, 1)
    wp = nt.barrett_factor(w, 64, q)
    for size in sizes:
        if not size:
            continue
        for in_offset in (0, 1):
            a, b = (rand(size, q, in_offset) for _ in range(2))
            x = rand(size, 1 << 64, in_offset)
            out = placed(torch.empty_like(a), 1)
            tag = (f"q_bits={q_bits} count={size} out offset 1, inputs "
                   f"{in_offset}")
            compare("K4", eltwise_into(ops, build, out, "mult", 64, a, b,
                                       q=q, s=(mu, 0, 0), i=(shift, 1)),
                    plain64.mult_mod(a, b, q, 1), f"mult_mod {tag}")
            compare("K8.reduce", eltwise_into(
                ops, build, out, "reduce", 64, x, q=q,
                s=(nt.barrett_factor(1, 64, q), 0, 0), i=(1, 1)),
                plain64.reduce_mod(x, q, q, 1), f"reduce_mod {tag}")
            checks += 2
            if q < 1 << 61:
                z = rand(size, 8 * q, in_offset)
                compare("K8.fma.approx", eltwise_into(
                    ops, build, out, "fma", 64, z, c=z, q=q, s=(w, wp, 0),
                    i=(0, 8), approx=True),
                    plain64.fma_mod_preconned(z, w, wp, z, q, 8, True),
                    f"fma_mod approx {tag}")
                checks += 1
            if q < ops.SMALL_Q:
                compare("K8.add_sub.u32", eltwise_into(
                    ops, build, out, "add", 32, a, b, q=q),
                    plain32.add_mod32(a, b, q), f"add_mod word=32 {tag}")
                checks += 1
    return checks


def rows_edge_checks(rng, dev, nt, ops, plain64, to_tensor, port_config,
                     compare, lengths=EDGE_COUNTS + (0,)) -> int:
    """K4.rows (IMF 1 and 4) and K8.reduce.rows, exact and approximate,
    over three rows of mixed moduli at each row length (an odd one starts
    every other row 8 bytes off), inputs placed at offsets 0 and 1.
    Returns the count."""
    import numpy as np
    import torch

    def rand(shape, bound, offset=0):
        return placed(to_tensor(rng.integers(0, bound - 1, size=shape,
                                             dtype=np.uint64, endpoint=True),
                                dev), offset)

    checks = 0
    regime = port_config.approx_butterflies
    moduli = [top_modulus(nt, b) for b in (29, 50, 60)]
    consts = ops.row_constants(tuple(moduli), dev)
    for m in lengths:
        for offset in ((0, 1) if m else (0,)):
            for approx in (False, True):
                port_config.approx_butterflies = lambda device: approx
                sfx = ".approx" if approx else ""
                tag = f"k=3 m={m} offset={offset} approx={approx}"
                try:
                    for imf in (1, 4):
                        a, b = (placed(torch.stack([rand(m, imf * q)
                                                    for q in moduli]),
                                       offset) for _ in range(2))
                        compare("K4.rows" + sfx,
                                ops.mult_mod_rows(a, b, moduli, imf),
                                plain64.mult_mod_rows(a, b, consts, imf,
                                                      approx),
                                f"mult_mod_rows imf={imf} {tag}")
                    x = rand((3, m), 1 << 64, offset)
                    compare("K8.reduce.rows" + sfx,
                            ops.reduce_mod_rows(x, moduli, 1),
                            plain64.reduce_mod_rows(x, consts, 1, approx),
                            f"reduce_mod_rows {tag}")
                finally:
                    port_config.approx_butterflies = regime
                checks += 3
    return checks


def block_parts(t, ds):
    """The (ds + 1, ds, n) block t in the three parts K10 reads: off (ds,
    ds - 1, n), row i's t[i][j] for j != i; diag (ds, n), t[i][i]; last
    (ds, n), t[ds]."""
    import torch
    off = torch.stack([torch.cat([t[i, :i], t[i, i + 1:]])
                       for i in range(ds)])
    return off, torch.stack([t[i, i] for i in range(ds)]), t[ds].clone()


def mac_edge_checks(rng, dev, nt, ks, to_tensor, compare, ds,
                    ns=EDGE_KS_NS + (0,)) -> int:
    """K10 and K10.approx (`mac_flush_parts`) at every kc of EDGE_KS_KCS
    over ds + 1 rows of mixed moduli, at each n (odd ones; n = 0 launches
    nothing), with each part of t and the keys placed at offset 1 (each
    alone and all four). Returns the count."""
    import numpy as np
    import torch

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound - 1, size=shape,
                                      dtype=np.uint64, endpoint=True), dev)

    checks = 0
    bits = (50, 29, 61, 45, 60, 40)[:ds] + (55,)
    moduli = [top_modulus(nt, b) for b in bits]
    msf = [nt.inverse_mod(moduli[-1] % q, q) for q in moduli[:ds]]
    c = ks.constants(tuple(moduli), tuple(msf), ds, dev)
    for n in ns:
        for kc in EDGE_KS_KCS:
            tq = torch.stack([rand((ds, n), 4 * q)
                              for q in moduli[:ds] + moduli[-1:]])
            keys = torch.stack([torch.stack([torch.stack([
                rand(n, q) for q in moduli]) for _ in range(kc)])
                for _ in range(ds)])
            operands = block_parts(tq, ds) + (keys,)
            for offs in ((0,) * 4, (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0),
                         (0, 0, 0, 1), (1,) * 4):
                if not n and any(offs):
                    continue
                args = [placed(x, o) for x, o in zip(operands, offs)]
                for approx in (False, True):
                    name = "K10" + (".approx" if approx else "")
                    compare(name, ks.mac_flush_parts(*args, c, ds, kc,
                                                     ds + 1, approx),
                            ks.mac_flush_plain(tq, keys, c.mac, ds, kc,
                                               ds + 1, approx),
                            f"mac_flush_parts n={n} ds={ds} kc={kc} offsets "
                            f"{offs} approx={approx}")
                    checks += 1
    return checks


def edge_kernel_checks(rng, dev, nt, build, ops, ks, plain64, plain32,
                       to_tensor, port_config, compare) -> int:
    """The streaming kernels at the edges of their 16-byte bodies, bit for
    bit against their plain versions: K4/K8 at EDGE_Q_BITS (2^22 + 3
    elements beside the odd counts), the row ops, K10 at EDGE_KS_DS.
    Returns the count."""
    checks = 0
    for q_bits in EDGE_Q_BITS:
        checks += eltwise_edge_checks(rng, dev, nt, build, ops, plain64,
                                      plain32, to_tensor, port_config,
                                      compare, q_bits)
    checks += rows_edge_checks(rng, dev, nt, ops, plain64, to_tensor,
                               port_config, compare)
    for ds in EDGE_KS_DS:
        checks += mac_edge_checks(rng, dev, nt, ks, to_tensor, compare, ds)
    return checks


def approx_kernel_checks(rng, dev, nt, get_plan, cuda_ntt, hier, shard, poly,
                         pipeline, ops, torch_kernels, torch_ntt, to_tensor,
                         port_config, compare, route) -> int:
    """Every instantiation of the "approx" scheme (the butterflies of the
    JAX package's Pallas kernels) and of the eltwise family's approximate
    quotients against its plain version, bit for bit, lazy outputs
    included: K1/K2 at every N from 2 to 2^14 and K5/K6 at every N from
    2^15 to 2^20, for q just above 2^29, 2^50 and 2^60 and just below
    2^61, over the IMF/OMF matrix (fully reduced outputs also against the
    exact kernels'); K3 at every N from 2 to 2^14 in every form it takes;
    K16 at every stage of N in {2^10, 2^14, 2^17}; K6 with a shard base
    (a DistNTT position's local pass) for L from 2^10 to 2^16; K4 and K8
    (mult_mod, fma_mod, reduce_mod, cmp_sub_mod, montgomery_form_in, and
    the row ops) at every IMF/OMF for q of 20, 29, 49, 60 and 61 bits and
    the largest prime below 2^62. Returns the count."""
    import numpy as np

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    checks = 0
    a_ = "approx"
    for log_n in range(1, 15):
        n = 1 << log_n
        batches = ((3, 401) if n in (2, 16, 1024, 4096, 1 << 13, 1 << 14)
                   else (1, 3))
        for q_bits, batch in itertools.product(APPROX_Q_BITS, batches):
            q = approx_modulus(nt, q_bits, n)
            plan = get_plan(n, q)
            kernel = hier.kernel_name(route(n, batch), 64, a_)
            what = f"n={n} q_bits={q_bits} approx batch={batch}"
            for imf in (1, 2, 4):
                x = rand((batch, n), imf * q)
                for omf in (1, 4):
                    got = cuda_ntt.fwd_ntt(x, plan, imf, omf, 64, a_)
                    compare(kernel, got, torch_ntt.fwd_ntt(
                        x, plan, imf, omf, 64, a_),
                        f"fwd {what} imf={imf} omf={omf}")
                    checks += 1
                    if omf == 1:
                        compare(kernel, got, cuda_ntt.fwd_ntt(x, plan, imf, 1),
                                f"fwd {what} imf={imf} OMF 1 == exact")
                        checks += 1
            for imf in (1, 2):
                x = rand((batch, n), imf * q)
                for omf in (1, 2):
                    got = cuda_ntt.inv_ntt(x, plan, imf, omf, 64, a_)
                    compare(kernel, got, torch_ntt.inv_ntt(
                        x, plan, imf, omf, 64, a_),
                        f"inv {what} imf={imf} omf={omf}")
                    checks += 1
                    if omf == 1:
                        compare(kernel, got, cuda_ntt.inv_ntt(x, plan, imf, 1),
                                f"inv {what} imf={imf} OMF 1 == exact")
                        checks += 1
    for n in (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20):
        for q_bits in APPROX_Q_BITS:
            q = approx_modulus(nt, q_bits, n)
            plan = get_plan(n, q)
            for batch in ((1, 2) if n == 1 << 20 else (1, 3)):
                blocks = (batch, n // hier.LOCAL_N, hier.LOCAL_N)
                k5 = k5_name(hier, n, batch, 64, a_)
                k6 = hier.kernel_name("K6", 64, a_)
                what = f"n={n} q_bits={q_bits} approx batch={batch}"
                for imf in (1, 2, 4):
                    x = rand(blocks, imf * q)
                    c = hier.cross(x, plan, True, 1, 64, a_)
                    compare(k5, c, hier.cross_fwd_plain(x, plan, 64, a_),
                            f"cross fwd {what} imf={imf}")
                    c = c.view(batch, n)
                    for omf in (1, 4):
                        compare(k6, hier.local(c, plan, True, omf, 64, a_),
                                hier.local_fwd_plain(c, plan, omf, 64, a_),
                                f"local fwd {what} imf={imf} omf={omf}")
                    flat = x.view(batch, n)
                    compare(k6, cuda_ntt.fwd_ntt(flat, plan, imf, 1, 64, a_),
                            cuda_ntt.fwd_ntt(flat, plan, imf, 1),
                            f"fwd {what} imf={imf} OMF 1 == exact")
                    checks += 4
                for imf in (1, 2):
                    x = rand((batch, n), imf * q)
                    loc = hier.local(x, plan, False, 1, 64, a_)
                    compare(k6, loc, hier.local_inv_plain(x, plan, 64, a_),
                            f"local inv {what} imf={imf}")
                    for omf in (1, 2):
                        compare(k5, hier.cross(loc.view(blocks), plan, False,
                                               omf, 64, a_),
                                hier.cross_inv_plain(loc.view(blocks), plan,
                                                     omf, 64, a_),
                                f"cross inv {what} imf={imf} omf={omf}")
                    compare(k5, cuda_ntt.inv_ntt(x, plan, imf, 1, 64, a_),
                            cuda_ntt.inv_ntt(x, plan, imf, 1),
                            f"inv {what} imf={imf} OMF 1 == exact")
                    checks += 4
    # K3 in every form at every N (the plain approx chain; fully reduced,
    # so the exact K3's output too).
    for log_n in range(1, 15):
        n = 1 << log_n
        q = approx_modulus(nt, 61 if log_n % 2 else 60, n)
        plan = get_plan(n, q)
        for batch in (1, 2, 133):
            a, b = rand((batch, n), q), rand((batch, n), q)
            want = poly.poly_mult_plain(a, b, plan, a_)
            for form in poly.forms_of(n):
                with forced_form(poly, form):
                    got = poly.poly_mult(a, b, plan, a_)
                    exact = poly.poly_mult(a, b, plan)
                name = poly.FORMS[form] + ".approx"
                compare(name, got, want, f"poly_mult n={n} batch={batch} "
                        f"form={form} approx")
                compare(name, got, exact, f"poly_mult n={n} batch={batch} "
                        f"form={form} approx == exact")
                checks += 2
    # K16 at every stage, approx.
    for log_n in (10, 14, 17):
        n = 1 << log_n
        for q_bits in APPROX_Q_BITS:
            q = approx_modulus(nt, q_bits, n)
            plan = get_plan(n, q)
            for k in range(log_n):
                last = k == log_n - 1
                for forward, bound, omfs in (
                        (True, 4 * q, (1, 4) if last else (4,)),
                        (False, 2 * q, (1, 2) if last else (2,))):
                    x = rand((2, n), bound)
                    for omf in omfs:
                        compare("K16.approx",
                                pipeline.stages(x, plan, forward, k, k + 1,
                                                omf, a_),
                                pipeline.stages_plain(x, plan, forward, k,
                                                      k + 1, omf, a_),
                                f"stage {k} of N=2^{log_n} q_bits={q_bits} "
                                f"{'fwd' if forward else 'inv'} omf={omf} "
                                "approx")
                        checks += 1
    # K6 with a shard base (and K5 on a shard's stages above 2^14): a
    # DistNTT position's local pass in approx.
    for log_l in range(10, 17):
        for d, q_bits in ((2, 61), (8, 50)):
            n = d << log_l
            q = approx_modulus(nt, q_bits, n)
            plan = get_plan(n, q)
            for r in (0, d - 1):
                what = f"L=2^{log_l} D={d} r={r} q_bits={q_bits} approx"
                x = rand((3, n // d), 4 * q)
                for omf in (1, 4):
                    compare("K6.approx", shard.local(x, plan, r, d, True, omf,
                                                     a_),
                            shard.local_fwd_plain(x, plan, r, d, omf, a_),
                            f"local fwd {what} omf={omf}")
                x = rand((3, n // d), 2 * q)
                compare("K6.approx", shard.local(x, plan, r, d, False, 1, a_),
                        shard.local_inv_plain(x, plan, r, d, a_),
                        f"local inv {what}")
                checks += 3
    # K4/K8's approximate instantiations, the switch forced on.
    regime = port_config.approx_butterflies
    port_config.approx_butterflies = lambda device: True
    try:
        for q_bits in (20, 29, 49, 60, 61, 62):
            q = top_modulus(nt, q_bits)
            for what, kernel, got, want in eltwise_approx_cases(
                    q, 65537, rng, dev, ops, torch_kernels, nt, to_tensor):
                compare(kernel, got, want, f"{what} q_bits={q_bits}")
                checks += 1
    finally:
        port_config.approx_butterflies = regime
    return checks


def composite_approx_checks(rng, dev, nt, get_plan, poly, dyadic, ks,
                            to_tensor, port_config, compare) -> int:
    """The approximate-quotient instantiations of the composites and K3's
    lean ones against their plain versions, bit for bit, and (fully
    reduced outputs) against the exact ones: K9.approx at W = 1 and 3 over
    moduli of mixed bit lengths; K10.approx on bases whose flushed rows
    differ in bit length; K11.approx's spread (its lazy [0, 2 q_i) outputs)
    and fold; K3 and K3.cta in lean16 and lean8 at every N from 2 to 2^14
    in every form they take. The moduli are `approx_modulus`'s, at which
    the approximate quotient is one too small for some inputs. Returns the
    count."""
    import numpy as np
    import torch

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    def rows(moduli, shape):
        return torch.stack([rand(shape, q) for q in moduli])

    checks = 0
    basis = [approx_modulus(nt, b, 1 << 15) for b in APPROX_Q_BITS]
    consts = dyadic.row_constants(tuple(basis), dev)
    regime = port_config.approx_butterflies
    for weights, n in ((1, 4099), (3, 4099), (1, 1 << 17), (3, 1 << 14)):
        x, y = (torch.stack([torch.stack([rows(basis, (n,))
                                          for _ in range(2)])
                             for _ in range(weights)]) for _ in range(2))
        port_config.approx_butterflies = lambda device: True
        try:
            got = dyadic.dyadic(x, y, basis)
        finally:
            port_config.approx_butterflies = regime
        what = f"dyadic W={weights} n={n} approx"
        compare("K9.approx", got, dyadic.dyadic_plain(x, y, consts, True),
                what)
        compare("K9.approx", got, dyadic.dyadic(x, y, basis),
                what + " == exact")
        checks += 2
    for n, bits, kc in ((64, (29, 50, 60, 61), 2),
                        (1 << 14, (50, 29, 61), 3),
                        (1 << 15, (49,) * 14 + (55,), 2)):
        moduli = []
        for b in bits:
            cands = ([approx_modulus(nt, b, n)] if b == 61 else
                     nt.generate_primes(len(bits) + 1, b, True, ntt_size=n))
            moduli.append(next(q for q in cands if q not in moduli))
        ds = len(bits) - 1
        msf = [nt.inverse_mod(moduli[-1] % q, q) for q in moduli[:ds]]
        result = torch.stack([rows(moduli[:ds], (n,)) for _ in range(kc)])
        c = ks.constants(tuple(moduli), tuple(msf), ds, dev)
        what = f"n={n} bits={bits[:4]} kc={kc} approx"
        tq = torch.stack([rand((ds, n), 4 * q)
                          for q in moduli[:ds] + moduli[-1:]])
        keys = torch.stack([torch.stack([rows(moduli, (n,))
                                         for _ in range(kc)])
                            for _ in range(ds)])
        parts = block_parts(tq, ds)
        tpp = ks.mac_flush_parts(*parts, keys, c, ds, kc, ds + 1, True)
        compare("K10.approx", tpp, ks.mac_flush_plain(tq, keys, c.mac, ds,
                                                      kc, ds + 1, True),
                f"mac_flush_parts {what}")
        compare("K10.approx", tpp, ks.mac_flush_parts(*parts, keys, c, ds,
                                                      kc, ds + 1),
                f"mac_flush_parts {what} == exact")
        x = rand((kc, n), 2 * moduli[-1])
        compare("K11.approx", ks.spread(x, c, True),
                ks.spread_plain(x, c, True), f"spread {what}")
        tntt = torch.stack([rand((kc, n), 4 * q) for q in moduli[:ds]])
        got = ks.fold(result, tpp, tntt, c, True)
        compare("K11.approx", got, ks.fold_plain(result, tpp, tntt, c, True),
                f"fold {what}")
        compare("K11.approx", got, ks.fold(result, tpp, tntt, c),
                f"fold {what} == exact")
        checks += 5
    for log_n in range(1, 15):
        n = 1 << log_n
        for scheme, q_bits in (("lean16", 59), ("lean8", 61), ("lean8", 60)):
            q = approx_modulus(nt, q_bits, n)
            plan = get_plan(n, q)
            for batch in ((1, 2, 133) if log_n >= 12 else (3,)):
                a, b = rand((batch, n), q), rand((batch, n), q)
                want = poly.poly_mult_plain(a, b, plan, scheme)
                for form in poly.forms_of(n):
                    with forced_form(poly, form):
                        got = poly.poly_mult(a, b, plan, scheme)
                        exact = poly.poly_mult(a, b, plan)
                    name = f"{poly.FORMS[form]}.{scheme}"
                    what = (f"poly_mult n={n} q_bits={q_bits} batch={batch} "
                            f"form={form} {scheme}")
                    compare(name, got, want, what)
                    compare(name, got, exact, what + " == exact")
                    checks += 2
    return checks


def packed_kernel_checks(rng, dev, nt, get_plan, cuda_ntt, hier, torch_ntt,
                         to_tensor, compare):
    """K2 (several polynomials per CTA) against the plain walk, bit for bit,
    at every N from 2 to 2^12 (49-bit q): through the packing rule at the
    batches 2^k and 2^k + 1 up to PACK_COEFFS and 3 PACK_COEFFS + 1, every
    P the rule gives (exact, every IMF/OMF pair), and with P forced to
    every power of two the kernel takes, on 2P + 1 polynomials (a ragged
    last CTA), in every scheme and every IMF/OMF pair. Returns the
    count."""
    import numpy as np

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    rule = cuda_ntt.polys_per_cta
    checks = 0
    for log_n in range(1, 13):
        n = 1 << log_n
        q = nt.generate_primes(1, 49, True, ntt_size=n)[0]
        plan = get_plan(n, q)
        top = cuda_ntt.PACK_COEFFS
        batches = sorted({*(1 << k for k in range(1, top.bit_length())),
                          *((1 << k) + 1 for k in range(1, top.bit_length())),
                          3 * top + 1})
        runs = [(batch, None, ("exact",)) for batch in batches
                if rule(n, batch) > 1]
        p = 2
        while p <= cuda_ntt.max_polys_per_cta(n):
            runs.append((2 * p + 1, p, torch_ntt.SCHEMES))
            p *= 2
        for batch, forced, schemes in runs:
            if forced:
                cuda_ntt.polys_per_cta = lambda *args, p=forced: p
            try:
                for scheme in schemes:
                    kernel = hier.kernel_name("K2", 64, scheme)
                    what = f"n={n} batch={batch} P={forced or 'rule'} {scheme}"
                    for imf in torch_ntt.FWD_IMF:
                        for omf in torch_ntt.FWD_OMF:
                            x = rand((batch, n), imf * q)
                            compare(kernel, cuda_ntt.fwd_ntt(
                                x, plan, imf, omf, 64, scheme),
                                torch_ntt.fwd_ntt(x, plan, imf, omf, 64,
                                                  scheme),
                                f"K2 fwd {what} imf={imf} omf={omf}")
                            checks += 1
                    for imf in torch_ntt.INV_IMF:
                        for omf in torch_ntt.INV_OMF:
                            x = rand((batch, n), imf * q)
                            compare(kernel, cuda_ntt.inv_ntt(
                                x, plan, imf, omf, 64, scheme),
                                torch_ntt.inv_ntt(x, plan, imf, omf, 64,
                                                  scheme),
                                f"K2 inv {what} imf={imf} omf={omf}")
                            checks += 1
            finally:
                cuda_ntt.polys_per_cta = rule
    return checks


def chain_kernel_checks(rng, dev, chain, df_chain, compare, compare_fft):
    """K17 (lean16 and its exact sibling) and K18 in every precision, at
    the probes' shapes and on a ragged 7 x 143 elements, each against its
    plain version, bit for bit. Returns the count."""
    checks = 0
    for shape in ((chain.ROWS, chain.LANES), (7, 143)):
        x, y = chain.probe_inputs(rng, dev, *shape)
        for scheme in ("lean16", "exact"):
            got = chain.chain(x, y, chain.PROBE_W, chain.PROBE_Q, chain.REPS,
                              scheme)
            want = chain.chain_plain(x, y, chain.PROBE_W, chain.PROBE_Q,
                                     chain.REPS, scheme)
            for g, w, leg in zip(got, want, "xy"):
                compare(chain.kernel_name(scheme), g, w,
                        f"chain {scheme} {shape} {leg}")
                checks += 1
    for precision in df_chain.PRECISIONS:
        w = df_chain.twiddle(precision, dev)
        s = df_chain.shrink(precision)
        for shape in ((df_chain.ROWS, df_chain.LANES), (7, 143)):
            x, y = (fft_value(rng, shape, precision, dev) for _ in range(2))
            got = df_chain.chain(x, y, w, s, precision)
            want = df_chain.chain_plain(x, y, w, s, precision)
            for g, v, leg in zip(got, want, "xy"):
                compare_fft(df_chain.kernel_name(precision), g, v, precision,
                            f"df chain {precision} {shape} {leg}")
                checks += 1
    return checks


def ckks_words(coeffs, q_words):
    """A CKKS plaintext as the decryption would leave it: the real and
    imaginary parts of the encoded coefficients rounded to integers at
    2^FIXED_POINT_BITS times the scale, mod the 2-word Q (a negative m as
    Q - |m|). Returns int64 words of u64 bits shaped (2 words, 2 parts,
    *coeffs.shape)."""
    import torch
    from hexl_tpu_torch.limb import lt64, s64
    parts = torch.stack([coeffs.real, coeffs.imag]).to(torch.float64)
    m = torch.round(parts * 2.0 ** FIXED_POINT_BITS).to(torch.int64)
    neg, mag = m < 0, m.abs()
    q_lo, q_hi = s64(q_words[0]), s64(q_words[1])
    lo = torch.where(neg, q_lo - mag, m)
    borrow = (neg & lt64(torch.full_like(mag, q_lo), mag)).to(torch.int64)
    hi = torch.where(neg, q_hi - borrow, torch.zeros_like(m))
    return torch.stack([lo, hi])


@contextlib.contextmanager
def forced_form(poly, form):
    """poly_mult runs K3 in `form` instead of `poly.form_for`'s pick."""
    choose = poly.form_for
    poly.form_for = lambda *args: form
    try:
        yield
    finally:
        poly.form_for = choose


def rotating(values):
    """A function giving the next of `values` at each call."""
    it = itertools.cycle(values)
    return lambda: next(it)


def graph_times(fn, inner, reps=20):
    """Device ms of one call of fn in each of `reps` replays of a CUDA
    graph holding `inner` calls (no host gaps between launches), after
    three warm-up calls on a side stream."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    del graph
    return times


# The timing rows of the radix walk, on inputs that rotate: each call runs
# one forward + inverse on the next of several input sets, so that a
# graph's calls read more than the 50 MB L2 holds. Rows 1, 6 and 10 and
# the lean row's K1/K6 (K1: 3 sets of 32 MB; K6: 4 of 2 x 16 MB;
# K6.shard: 8 of 2 x 4 MB); row 7, K7, at 2^14 (its phase-5 shape), 2^13,
# 2^15 and 2^10 (3 sets of 32 MB each); row 11, K12's block pass in each
# precision, and the whole f64 FFT-like pair (K13 + K12 each way), at
# 2^14 x 64 (6 sets of 16 MB); row 2: "K2" the public pair at (2^10,
# 49-bit, 4096) (3 sets of 32 MB; one polynomial per CTA by the packing
# rule, so K1 there), "K2.n6" K2's packed pair at (2^6, 49-bit,
# 8192) (16 sets of 4 MB); row 3: "K3" the product at (2^14, 60-bit, 64)
# (3 sets of a, b and the output, 24 MB), "K3.cta" at (2^13, 60-bit, 132)
# (3 sets of 26 MB, the one-CTA form), "K3.n10" at (2^10, 60-bit, 64)
# (the one-CTA form) and "K3.n12" at (2^12, 50-bit, 2); row 5: "K5.d8" ..
# "K5.d64", K5's forward + inverse at D = 8 .. 64 (k5_run: N x batch =
# 2^21, 3 sets of 32 MB) in the rule's form (the tiled one at D = 64,
# "K5.tile"'s row). "torch.fft" is
# torch.fft.fft + ifft of a (64, 2^14) complex128, the nearest library
# call to the f64 pair (another function), timed on both sides as a
# yardstick. WALK_ROWS maps each kernels-line entry timed here to its
# row.
WALK_ROWS = {name: name for name in (
    "K1", "K1.lean8", "K1.lean16", "K6", "K6.u32", "K6.lean16", "K6.shard",
    "K7", "K12.f64", "K12.f32", "K12.df", "K3", "K3.cta")}
WALK_ROWS["K2"] = "K2.n6"
WALK_ROWS["K5.tile"] = "K5.d64"
# The kernels-line entries timed on `stream_runs`' rows (rotating inputs at
# the entries' shapes), as WALK_ROWS' on `walk_runs`'.
STREAM_ROWS = {name: name for name in (
    "K8.add_sub", "K8.add_sub.u32", "K8.mult.u32", "K8.fma", "K8.fma.u32",
    "K8.reduce", "K8.reduce.u32", "K8.cmp", "K8.mont", "K4.rows",
    "K8.reduce.rows")}
STREAM_ROWS.update({"K4": "K4.small", "K10": "K10.n15.ds14"})


def walk_runs(rng, dev, nt, get_plan, cuda_ntt, hier, shard,
              to_tensor, fifth=False) -> dict:
    """{row: fn} for WALK_ROWS' rows and the A/B's other rows (K7.n13,
    K7.n15, K7.n10, FFT.f64, torch.fft, K2, K3.n10, K3.n12, K5.d8 ..
    K5.d64, and `rns_runs`' RNS.prod, RNS.n14, RNS.n17, KS.ntts, KS), at
    the shapes
    of phase 5: the pair (2^14, batch 256; 60-bit q, lean16 at 59 bits, K7
    at 29 bits; K7 also at (2^13, 512), (2^15, 128) and (2^10, 4096); the
    public route at (2^10, 49-bit, 4096), K2 at (2^6, 49-bit, 8192)), the
    local pass of N = 2^17 x 16 (60-bit, 29-bit u32, lean16 at 50 bits),
    position 3 of 8 at bench.py's shape (L = 2^11, batch 256), the
    FFT-like of the fourth path (2^14 x 64, scale 2^40), and poly_mult at
    (2^14, 60-bit, 64), (2^13, 60-bit, 132), (2^10, 60-bit, 64) and
    (2^12, 50-bit, 2). With `fifth`, also the local pass of a DistNTT
    position at every shape of the fifth path (`local_pass_runs`, rows
    "K6.shard N=..."), and each fifth-path call (rows "fifth: ...", one
    call a graph replay in `walk_times`). Written against the wrappers'
    signatures, which the parent tree of an A/B (`--walk-ab`) shares."""
    import numpy as np
    import torch
    from hexl_tpu_torch import FFTLike, poly
    from hexl_tpu_torch.experimental import cuda_fft

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    n14, n17 = 1 << 14, 1 << 17

    def prime(bits, n):
        return nt.generate_primes(1, bits, True, ntt_size=n)[0]

    def pair(q, scheme, word=64, sets=3, n=n14, batch=256):
        plan = get_plan(n, q)
        nxt = rotating([rand((batch, n), q) for _ in range(sets)])
        return lambda: cuda_ntt.inv_ntt(
            cuda_ntt.fwd_ntt(nxt(), plan, 1, 1, word, scheme), plan, 1, 1,
            word, scheme)

    def local(q, scheme, word=64, sets=4):
        plan = get_plan(n17, q)
        nxt = rotating([(rand((SPLIT_BATCH, n17), q),
                         rand((SPLIT_BATCH, n17), 2 * q))
                        for _ in range(sets)])

        def run():
            xf, xi = nxt()
            return (hier.local(xf, plan, True, 1, word, scheme),
                    hier.local(xi, plan, False, 1, word, scheme))
        return run

    q60 = prime(60, n14)
    plan14 = get_plan(n14, q60)
    nxt_shard = rotating([(rand((256, n14 // 8), q60),
                           rand((256, n14 // 8), 2 * q60))
                          for _ in range(8)])

    def shard_run():
        xf, xi = nxt_shard()
        return (shard.local(xf, plan14, 3, 8, True, 1),
                shard.local(xi, plan14, 3, 8, False))

    def fft_run(prec, fn):
        e = FFTLike(FFT_N, FFT_SCALAR, precision=prec, device=dev)
        fwd_t, inv_t = e.tables(dev)
        sf, si = e.fused_scale(True), e.fused_scale(False)
        nxt = rotating([fft_value(rng, (FFT_BATCH, FFT_N), prec, dev)
                        for _ in range(6)])
        if fn is None:   # the whole transform, forward then inverse
            return lambda: cuda_fft.inverse(
                cuda_fft.forward(nxt(), fwd_t, sf, prec), inv_t, si, prec)
        return lambda: (fn(nxt(), fwd_t, sf, prec, True),
                        fn(nxt(), inv_t, si, prec, False))

    z = rotating([fft_value(rng, (FFT_BATCH, FFT_N), "f64", dev)
                  for _ in range(6)])
    q29 = prime(29, 1 << 15)

    def product(n, bits, batch):
        plan = get_plan(n, prime(bits, n))
        nxt = rotating([(rand((batch, n), plan.q), rand((batch, n), plan.q))
                        for _ in range(3)])
        return lambda: poly.poly_mult(*nxt(), plan)

    from hexl_tpu_torch import key_switch, rns_poly_mult_mod
    from hexl_tpu_torch.eltwise import ops
    from hexl_tpu_torch.ntt import rns, torch_ntt

    extra = {}
    if fifth:
        f5 = fifth_path(rng, dev, nt.generate_primes(RNS_PRIMES, 50, True,
                                                     ntt_size=n17))
        extra = {name: fn for name, (fn, _) in local_pass_runs(
            rng, dev, shard, hier,
            fifth_local_shapes(f5.calls, shard)).items()}
        extra.update({f"fifth: {name}": call
                      for name, (call, _, _) in f5.calls.items()})
    return {**extra, "K1": pair(q60, "exact"),
            "K1.lean8": pair(q60, "lean8"),
            "K1.lean16": pair(prime(59, n14), "lean16"),
            "K6": local(prime(60, n17), "exact"),
            "K6.u32": local(prime(29, n17), "exact", 32),
            "K6.lean16": local(prime(50, n17), "lean16"),
            "K6.shard": shard_run,
            "K7": pair(q29, "exact", 32),
            "K7.n13": pair(q29, "exact", 32, n=1 << 13, batch=512),
            "K7.n15": pair(q29, "exact", 32, n=1 << 15, batch=128),
            "K7.n10": pair(q29, "exact", 32, n=1 << 10, batch=N10_BATCH),
            "K12.f64": fft_run("f64", cuda_fft.block),
            "K12.f32": fft_run("single", cuda_fft.block),
            "K12.df": fft_run("double_float", cuda_fft.block),
            "FFT.f64": fft_run("f64", None),
            "torch.fft": lambda: torch.fft.ifft(torch.fft.fft(z())),
            "K2": pair(prime(49, 1 << 10), "exact", n=1 << 10,
                       batch=N10_BATCH),
            "K2.n6": pair(prime(49, PACKED_N), "exact", sets=16, n=PACKED_N,
                          batch=PACKED_BATCH),
            "K3": product(n14, 60, 64),
            "K3.cta": product(CTA_N, 60, CTA_BATCH),
            "K3.n10": product(1 << 10, 60, 64),
            "K3.n12": product(1 << 12, 50, 2),
            **{f"K5.d{1 << log_d}": k5_run(rng, dev, nt, get_plan, hier,
                                           to_tensor, log_d, 64)[0]
               for log_d in range(3, 7)},
            **rns_runs(rng, dev, nt, get_plan, cuda_ntt, rns, to_tensor,
                       rns_poly_mult_mod, key_switch),
            **{row: fn for row, (fn, _) in ks_runs(
                rng, dev, nt, get_plan, cuda_ntt, hier, rns, torch_ntt,
                to_tensor, key_switch, ops.mult_mod).items()
               if row in WALK_KS_ROWS}}


# The key switch rows of the A/B beside rns_runs' KS and KS.ntts (N=2^15 x
# ds 14): the other three KS_SHAPES and the graft pipeline (`ks_runs`).
WALK_KS_ROWS = ("KS.n14.ds3", "KS.n14.ds3.ntts", "KS.n14.ds5",
                "KS.n14.ds5.ntts", "KS.n15.ds3", "KS.n15.ds3.ntts", "graft")


# The streaming kernels' rows of the A/B (`stream_runs`): each K8 family and
# K4 at 2^22 elements (BIG; 60-bit q, i.e. q in (2^60, 2^61), or 29-bit for
# the single word), "K4.small" at K4's main-path shape (2 x 2^12, IMF 4,
# 50-bit), the approximate forms, the row ops at phase 5's shapes, and
# torch.remainder on K8.reduce.imf4's and K8.reduce.u32's inputs (the one
# PyTorch call of reduce_mod IMF 4 -> OMF 1), and an int64 copy and sum
# as yardsticks of the card's rate for two- and three-word traffic (other
# functions); K10 and K10.approx at every
# KS_SHAPES entry (49-bit primes), kc 2 and kc 1 on the same t. Every row
# rotates input sets beyond the 50 MB L2 (STREAM_L2_BYTES of inputs at
# least, two sets at least), and keeps each call's output until its input
# set comes round again (`kept`), so that a graph's calls write fresh
# buffers, not one buffer the L2 holds.
STREAM_L2_BYTES = 160e6


def kept(fn, count):
    """fn, each of its outputs kept alive for `count` calls (a ring), so
    that `count` calls in a row write `count` distinct buffers."""
    ring = collections.deque(maxlen=count)

    def run():
        out = fn()
        ring.append(out)
        return out
    return run


def stream_runs(rng, dev, nt, ops, ks, port_config, to_tensor) -> dict:
    """{row: (fn, bytes)} of the streaming kernels' rows (see above), each
    fn one call on the next input set; bytes: each input read once and
    the output written once, the rows' bytes bound. Through the public
    wrappers (`ops.*`, `ks.mac_flush_parts`, `ks.constants`) that an earlier
    tree of the port shares; the approximate forms with
    `config.approx_butterflies` forced on around each call."""
    import numpy as np
    import torch

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound - 1, size=shape,
                                      dtype=np.uint64, endpoint=True), dev)

    def sets_for(nbytes):
        return max(2, -(-int(STREAM_L2_BYTES) // nbytes))

    def rotate(make, nbytes):
        return rotating([make() for _ in range(sets_for(nbytes))])

    def forced(fn):
        def run():
            regime = port_config.approx_butterflies
            port_config.approx_butterflies = lambda device: True
            try:
                return fn()
            finally:
                port_config.approx_butterflies = regime
        return run

    runs = {}
    elems = BIG[0] * BIG[1] * BIG[2]
    word = 8 * elems
    q60, q29 = top_modulus(nt, 60, BIG[-1]), top_modulus(nt, 29, BIG[-1])
    w60 = (12345, nt.barrett_factor(12345, 64, q60))
    w29 = (12345, nt.barrett_factor(12345, 32, q29))

    def elt(name, bounds, call, approx=False):
        nbytes = len(bounds) * word
        nxt = rotate(lambda: [rand(BIG, b) for b in bounds], nbytes)
        fn = kept(lambda: call(*nxt()), sets_for(nbytes))
        runs[name] = (forced(fn) if approx else fn,
                      (len(bounds) + 1) * word)

    elt("K4", (4 * q60, 4 * q60), lambda a, b: ops.mult_mod(a, b, q60, 4))
    elt("K4.approx", (4 * q60, 4 * q60),
        lambda a, b: ops.mult_mod(a, b, q60, 4), True)
    elt("K8.add_sub", (q60, q60), lambda a, b: ops.add_mod(a, b, q60))
    elt("K8.add_sub.u32", (q29, q29), lambda a, b: ops.add_mod(a, b, q29, 32))
    elt("K8.mult.u32", (q29, q29),
        lambda a, b: ops.mult_mod(a, b, q29, 1, 32))
    elt("K8.fma", (8 * q60, 8 * q60),
        lambda a, c: ops.fma_mod(a, *w60, c, q60, 8))
    elt("K8.fma.approx", (8 * q60, 8 * q60),
        lambda a, c: ops.fma_mod(a, *w60, c, q60, 8), True)
    elt("K8.fma.u32", (8 * q29, 8 * q29),
        lambda a, c: ops.fma_mod(a, *w29, c, q29, 8, 32))
    elt("K8.reduce", (1 << 64,), lambda x: ops.reduce_mod(x, q60, q60, 1))
    elt("K8.reduce.approx", (1 << 64,),
        lambda x: ops.reduce_mod(x, q60, q60, 1), True)
    elt("K8.reduce.imf4", (4 * q60,), lambda x: ops.reduce_mod(x, q60, 4, 1))
    elt("torch.remainder", (4 * q60,), lambda x: torch.remainder(x, q60))
    elt("K8.reduce.u32", (4 * q29,),
        lambda x: ops.reduce_mod(x, q29, 4, 1, 32))
    elt("torch.remainder.u32", (4 * q29,), lambda x: torch.remainder(x, q29))
    elt("K8.cmp", (1 << 64,),
        lambda x: ops.cmp_sub_mod(x, q60, "nlt", 1 << 63, 42))
    elt("K8.cmp.approx", (1 << 64,),
        lambda x: ops.cmp_sub_mod(x, q60, "nlt", 1 << 63, 42), True)
    elt("K8.cmp.add", (1 << 64,),
        lambda x: ops.cmp_add(x, "nlt", 1 << 63, 42))
    elt("K8.mont", (q60, q60),
        lambda a, b: ops.montgomery_mult_reduce(a, b, q60))
    elt("K8.mont.approx", (q60,), lambda a: ops.montgomery_form_in(a, q60),
        True)
    # Yardsticks of the card's rate for the same traffic (not the same
    # function): an int64 copy (two words an element) and an int64 sum
    # (three).
    elt("torch.copy", (1 << 63,), lambda x: x.clone())
    elt("torch.add", (1 << 62, 1 << 62), lambda a, b: a + b)
    # K4 at its main-path shape (2 x 2^12, IMF 4, 50-bit), where the launch
    # floor bounds it.
    q50 = nt.generate_primes(1, 50, True, ntt_size=1 << 12)[0]
    small_bytes = 2 * 8 * (2 << 12)
    small = rotate(lambda: [rand((2, 1 << 12), 4 * q50) for _ in range(2)],
                   small_bytes)
    runs["K4.small"] = (kept(lambda: ops.mult_mod(*small(), q50, 4),
                             sets_for(small_bytes)), 3 * 8 * (2 << 12))
    # The row ops: K4.rows at the RNS product's (16, 2^17), IMF 4;
    # K8.reduce.rows at the 2^15 x ds 14 key switch's base conversion,
    # (14, 13, 2^15) from IMF q.
    n17 = 1 << 17
    moduli = nt.generate_primes(RNS_PRIMES, 50, True, ntt_size=n17)
    rows_words = RNS_PRIMES * n17
    nxt_rows = rotate(lambda: [torch.stack([rand((n17,), 4 * q)
                                            for q in moduli])
                               for _ in range(2)], 2 * 8 * rows_words)
    run = kept(lambda: ops.mult_mod_rows(*nxt_rows(), moduli, 4),
               sets_for(2 * 8 * rows_words))
    runs["K4.rows"] = (run, 3 * 8 * rows_words)
    runs["K4.rows.approx"] = (forced(run), 3 * 8 * rows_words)
    n15, ds14 = KS_SHAPES[-1]
    red_moduli = nt.generate_primes(ds14, 49, True, ntt_size=n15)
    red_shape = (ds14, ds14 - 1, n15)
    red_words = ds14 * (ds14 - 1) * n15
    nxt_red = rotate(lambda: rand(red_shape, 1 << 64), 8 * red_words)
    run_red = kept(lambda: ops.reduce_mod_rows(nxt_red(), red_moduli),
                   sets_for(8 * red_words))
    runs["K8.reduce.rows"] = (run_red, 2 * 8 * red_words)
    runs["K8.reduce.rows.approx"] = (forced(run_red), 2 * 8 * red_words)
    # K10 at each key switch shape, kc 2 and kc 1 (the first component's
    # keys) on the same t.
    for n, ds in KS_SHAPES:
        ks_moduli = nt.generate_primes(ds + 1, 49, True, ntt_size=n)
        msf = [nt.inverse_mod(ks_moduli[-1] % q, q) for q in ks_moduli[:ds]]
        c = ks.constants(tuple(ks_moduli), tuple(msf), ds, dev)
        rns, kms = ds + 1, ds + 1
        t_words, key_words = rns * ds * n, ds * 2 * kms * n
        sets = []
        for _ in range(sets_for(8 * (t_words + key_words))):
            t = torch.stack([rand((ds, n), 4 * q) for q in ks_moduli])
            keys = torch.stack([torch.stack([torch.stack([
                rand((n,), q) for q in ks_moduli]) for _ in range(2)])
                for _ in range(ds)])
            sets.append(block_parts(t, ds)
                        + (keys, keys[:, :1].contiguous()))
        tag = f"K10%s.n{n.bit_length() - 1}.ds{ds}%s"
        for kc in (2, 1):
            nbytes = 8 * (t_words + kc * key_words // 2 + rns * kc * n)
            for approx in (False, True):
                def run(kc=kc, approx=approx, nxt=rotating(sets), c=c, ds=ds,
                        kms=kms):
                    *parts, keys2, keys1 = nxt()
                    return ks.mac_flush_parts(*parts, keys2 if kc == 2
                                              else keys1, c, ds, kc, kms,
                                              approx)
                runs[tag % (".approx" if approx else "",
                            "" if kc == 2 else ".kc1")] = (
                    kept(run, len(sets)), nbytes)
    return runs


def per_prime_rns(get_plan, cuda_ntt, poly):
    """The route of one call a prime (an earlier tree's `rns` module and
    RNS product), through this tree's single-modulus wrappers: the
    stacked functions' signatures, each a loop over the rows and a
    torch.stack."""
    import torch

    def loop(fn):
        return lambda x, plans, *args: torch.stack(
            [fn(x[i], p, *args) for i, p in enumerate(plans)])

    return SimpleNamespace(
        get_rns_plan=lambda n, moduli: [get_plan(n, q) for q in moduli],
        fwd_ntt_rns=loop(cuda_ntt.fwd_ntt), inv_ntt_rns=loop(cuda_ntt.inv_ntt),
        rns_poly_mult_mod=lambda a, b, n, moduli: torch.stack(
            [poly.poly_mult(a[i], b[i], get_plan(n, q))
             for i, q in enumerate(moduli)]))


def rns_runs(rng, dev, nt, get_plan, cuda_ntt, rns, to_tensor,
             rns_poly_mult_mod, key_switch=None) -> dict:
    """{row: fn} of the stacked transform's rows, through `rns`'s
    get_rns_plan/fwd_ntt_rns/inv_ntt_rns and `rns_poly_mult_mod` (this
    tree's, an earlier tree's, or `per_prime_rns`'): RNS.prod, the RNS
    product at 2^17 x 16 primes of 50 bits (3 sets of 32 MB); RNS.n14 and
    RNS.n17, the fwd+inv pair at (2^14, 16 primes, batch 16) (3 sets of
    32 MB) and (2^17, 16 primes, batch 1) (4 of 16 MB); KS.ntts, the
    transforms of the key switch at 2^15 x ds 14 (`key_switch_ntts`); and,
    given `key_switch`, KS, that key switch (kc 2, 49-bit)."""
    import numpy as np
    import torch

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    def rows(moduli, shape, factor=1):
        return torch.stack([rand(shape, factor * q) for q in moduli])

    n14, n17 = 1 << 14, 1 << 17

    def rns_product():
        moduli = nt.generate_primes(RNS_PRIMES, 50, True, ntt_size=n17)
        nxt = rotating([(rows(moduli, (n17,)), rows(moduli, (n17,)))
                        for _ in range(3)])
        return lambda: rns_poly_mult_mod(*nxt(), n17, moduli)

    def rns_pair(n, k, batch, sets):
        moduli = nt.generate_primes(k, 50, True, ntt_size=n)
        rplan = rns.get_rns_plan(n, moduli)
        nxt = rotating([rows(moduli, (batch, n)) for _ in range(sets)])
        return lambda: rns.inv_ntt_rns(rns.fwd_ntt_rns(nxt(), rplan), rplan)

    n15, ds14 = KS_SHAPES[-1]
    result, t, keys, ks_moduli, msf = key_switch_inputs(
        rng, n15, (49,) * (ds14 + 1), 2, dev, nt, to_tensor)
    runs = {"RNS.prod": rns_product(),
            "RNS.n14": rns_pair(n14, RNS_PRIMES, 16, 3),
            "RNS.n17": rns_pair(n17, RNS_PRIMES, 1, 4),
            "KS.ntts": key_switch_ntts(n15, ds14, ks_moduli, rand, get_plan,
                                       cuda_ntt, rns)}
    if key_switch is not None:
        runs["KS"] = lambda: key_switch(result, t, n15, ds14, ds14 + 1,
                                        ds14 + 1, 2, ks_moduli, keys, msf)
    return runs


# The fifth main path: the parallel layer on meshes of cuda:0 positions (one
# card holds every position, as one CPU holds the JAX package's virtual
# devices in its tests and dry run; this says nothing of NVLink or of
# scaling). BASELINE.json's north star, the RNS poly-mult at N=2^17 x 16
# primes of 50 bits, batch 2 (a polynomial per batch row), on the dry run's
# (batch 2, coeff 4) mesh (L = 2^15: K5 + K6 per position) and its
# 16-device (2, 8) mesh (L = 2^14); DistNTT fwd+inv at bench.py's shape
# (2^14, 60-bit, batch 256) on (1, 8) and (2, 4), on (2, 4) with
# overlap_slices=2, and on the D = 1 mesh; PipelineNTT at 2^14, 60-bit, 16
# microbatches of 16 on an 8-position ring; dist_key_switch at the dry
# run's shape (2^14, ds 3, kc 2, 49-bit) on (2, 4); and
# dist_dyadic_multiply on the same moduli.
def fifth_path(rng, dev, moduli) -> SimpleNamespace:
    """The fifth main path's calls, {name: (call, mesh, the same
    computation on one device)}, and their inputs, through the port on
    sys.path (this tree's, or an earlier one's for `--shard-times ROOT`
    and `--walk-ab`); `moduli` the RNS product's 16 primes."""
    import numpy as np
    import torch
    import hexl_tpu_torch as port
    from hexl_tpu_torch import nt, rns_poly_mult_mod
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import cuda_ntt, get_plan
    from hexl_tpu_torch.parallel import (DistNTT, PipelineNTT,
                                         dist_dyadic_multiply,
                                         dist_key_switch, dist_rns_poly_mult,
                                         make_mesh, make_pipeline_mesh)

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    n14, n17 = 1 << 14, 1 << 17
    q60 = nt.generate_primes(1, 60, True, ntt_size=n14)[0]
    plan14 = get_plan(n14, q60)
    meshes = {(nb, nc): make_mesh(nc, nb, [dev] * (nb * nc))
              for nb, nc in ((2, 4), (2, 8), (1, 8), (1, 1))}
    ra2 = torch.stack([rand((2, n17), q) for q in moduli])
    rb2 = torch.stack([rand((2, n17), q) for q in moduli])
    xd = rand((256, n14), q60)
    xp = rand((16, 16, n14), q60)
    ks_res, ks_t, ks_keys, ks5_moduli, ks_msf = key_switch_inputs(
        rng, n14, (49,) * 4, 2, dev, nt, to_tensor)
    dy5 = [torch.stack([torch.stack([rand((n14,), q) for q in ks5_moduli])
                        for _ in range(2)]) for _ in range(2)]
    dists = {"(1, 8)": DistNTT(n14, q60, meshes[(1, 8)]),
             "(2, 4)": DistNTT(n14, q60, meshes[(2, 4)]),
             "(2, 4), 2 slices": DistNTT(n14, q60, meshes[(2, 4)],
                                         overlap_slices=2),
             "(1, 1)": DistNTT(n14, q60, meshes[(1, 1)])}
    ring = make_pipeline_mesh(8, [dev] * 8)
    pipe = PipelineNTT(n14, q60, ring)

    def dist_pair(e):
        y = e.forward(xd)
        return y, e.inverse(y)

    fifth = {
        f"dist_rns_poly_mult N=2^17 x {RNS_PRIMES} primes, batch 2, "
        "mesh (2, 4)": (
            lambda: dist_rns_poly_mult(ra2, rb2, n17, moduli, meshes[(2, 4)]),
            meshes[(2, 4)], lambda: rns_poly_mult_mod(ra2, rb2, n17, moduli)),
        f"dist_rns_poly_mult N=2^17 x {RNS_PRIMES} primes, batch 2, "
        "mesh (2, 8)": (
            lambda: dist_rns_poly_mult(ra2, rb2, n17, moduli, meshes[(2, 8)]),
            meshes[(2, 8)], lambda: rns_poly_mult_mod(ra2, rb2, n17, moduli)),
    }
    for name, e in dists.items():
        fifth[f"DistNTT fwd+inv 2^14, 60-bit, batch 256, mesh {name}"] = (
            lambda e=e: dist_pair(e), e.mesh,
            lambda: (lambda y: (y, cuda_ntt.inv_ntt(y, plan14)))(
                cuda_ntt.fwd_ntt(xd, plan14)))
    fifth["PipelineNTT fwd+inv 2^14, 60-bit, 16 x 16, ring of 8"] = (
        lambda: (lambda y: (y, pipe.inverse(y)))(pipe.forward(xp)), ring,
        lambda: (lambda y: (y, cuda_ntt.inv_ntt(y, plan14)))(
            cuda_ntt.fwd_ntt(xp, plan14)))
    fifth["dist_key_switch 2^14, ds 3, kc 2, 49-bit, mesh (2, 4)"] = (
        lambda: dist_key_switch(ks_res, ks_t, n14, 3, 4, 4, 2, ks5_moduli,
                                ks_keys, ks_msf, meshes[(2, 4)]),
        meshes[(2, 4)],
        lambda: port.key_switch(ks_res, ks_t, n14, 3, 4, 4, 2, ks5_moduli,
                                ks_keys, ks_msf))
    fifth["dist_dyadic_multiply 2^14 x 4 moduli, mesh (2, 4)"] = (
        lambda: dist_dyadic_multiply(*dy5, ks5_moduli, meshes[(2, 4)]),
        meshes[(2, 4)], lambda: port.dyadic_multiply(*dy5, ks5_moduli))
    return SimpleNamespace(
        calls=fifth, ra2=ra2, rb2=rb2, xd=xd, xp=xp, dy5=dy5,
        key_switch=(ks_res, ks_t, ks_keys, ks5_moduli, ks_msf))


# K5 at every count of rows of the split, D = 2^log_d = 2 .. 64, at equal
# bytes: N = D 2^14 and batch 2^21 / N, i.e. (2^15, 64), (2^16, 32),
# (2^17, 16), (2^18, 8), (2^19, 4), (2^20, 2); forward on [0, q) and
# inverse (final stage, OMF 1) on [0, 2q) a call, on K5_SETS rotating input
# pairs (3 x 32 MB, beyond the 50 MB L2); a 60-bit q for word 64, 29-bit
# for word 32.
K5_COEFFS = 1 << 21
K5_SETS = 3
K5_KERNEL = re.compile(r"cross_(tile_)?(fwd|inv)_kernelI([yj])Li(\d)ELi(\d)E"
                       r"(?:Lb([01])E)?")


def k5_run(rng, dev, nt, get_plan, hier, to_tensor, log_d, word):
    """(fn, bytes, butterflies a direction, check) of K5's forward +
    inverse at D = 2^log_d (K5_COEFFS); check() gives the outputs of the
    first input set and the plain versions'. Bytes: every coefficient
    read and written once a direction, and the 2D - 3 table entries (and
    their preconditions) the two passes read."""
    import numpy as np
    n = hier.LOCAL_N << log_d
    q = nt.generate_primes(1, 29 if word == 32 else 60, True,
                           ntt_size=n)[0]
    plan = get_plan(n, q)
    shape = (K5_COEFFS // n, 1 << log_d, hier.LOCAL_N)

    def rand(bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    sets = [(rand(q), rand(2 * q)) for _ in range(K5_SETS)]
    nxt = rotating(sets)

    def run(inputs=None):
        xf, xi = inputs or nxt()
        return (hier.cross(xf, plan, True, 1, word),
                hier.cross(xi, plan, False, 1, word))

    def check():
        """The first set's outputs, and those of the plain versions."""
        xf, xi = sets[0]
        return run(sets[0]), (hier.cross_fwd_plain(xf, plan, word),
                              hier.cross_inv_plain(xi, plan, 1, word))
    nbytes = 2 * 2 * 8 * K5_COEFFS + 2 * 8 * (2 * (1 << log_d) - 3)
    return run, nbytes, K5_COEFFS // 2, check


def k5_resources(resources: dict) -> dict:
    """{(form, direction, word, log_d): (registers, spill store bytes)} of
    the exact K5 instantiations in a build's -Xptxas -v report (the
    inverse: its final-stage form)."""
    out = {}
    for name, (regs, _, spill, _) in resources.items():
        m = K5_KERNEL.search(name)
        if not m or m.group(4) != "0" or m.group(6) == "0":
            continue
        form = "tile" if m.group(1) else "column"
        word = 64 if m.group(3) == "y" else 32
        out[(form, m.group(2), word, int(m.group(5)))] = (regs, spill)
    return out


def k5_table(rng, dev, nt, get_plan, hier, to_tensor, resources, shoup,
             bound, log_ds=range(1, 7), words=(64, 32), only=None) -> list:
    """K5 at every D of K5_COEFFS in each word, in each form the wrapper
    takes there (`hier.cross_forms`; a tree without it has the column
    form alone): device ms in 20 graph replays of 20 calls, the bound
    (`bound(bytes, operations)`; operations: 2 log2(D) + 1 Shoups a
    butterfly, `shoup[word]` IMADs each), registers and CTAs per SM of the
    forward and the final inverse, and the form `hier.cross_form` takes."""
    import torch
    regs = k5_resources(resources)
    rows = []
    for word in words:
        for log_d in log_ds:
            run, nbytes, bflys, check = k5_run(rng, dev, nt, get_plan, hier,
                                               to_tensor, log_d, word)
            bound_ms, bound_by = bound(nbytes,
                                       (2 * log_d + 1) * bflys * shoup[word])
            n = hier.LOCAL_N << log_d
            batch = K5_COEFFS // n
            forms = (hier.cross_forms(log_d, hier.LOG_LOCAL)
                     if hasattr(hier, "cross_forms") else ["column"])
            rule = (hier.cross_form(log_d, hier.LOG_LOCAL, batch, word)
                    if hasattr(hier, "cross_form") else "column")
            for form in forms if only is None else [only]:
                with forced_cross_form(hier, form):
                    got, want = check()
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"K5's {form} form disagrees "
                                             f"with its plain version at D="
                                             f"{1 << log_d} word {word}")
                    times = graph_times(run, 20)
                ms = statistics.median(times)
                occ = [hier.cross_occupancy(log_d, fwd, word, dev, form)
                       if hasattr(hier, "cross_forms") else None
                       for fwd in (True, False)]
                row = {"D": 1 << log_d, "N": n, "batch": batch, "word": word,
                       "form": form, "rule": rule, "ms": ms,
                       "min": min(times), "max": max(times),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "share": bound_ms / ms,
                       "registers": [regs.get((form, d, word, log_d))
                                     for d in ("fwd", "inv")],
                       "ctas_per_sm": occ}
                rows.append(row)
                log(f"K5 D={row['D']} (N=2^{n.bit_length() - 1}, batch "
                    f"{batch}) word {word} form {form} (rule: {rule}): "
                    f"{ms:.4f} ms [{min(times):.4f}, {max(times):.4f}], "
                    f"bound {bound_ms:.4f} ms ({bound_by}), "
                    f"{bound_ms / ms:.1%}; registers (fwd, inv) "
                    f"{row['registers']}, CTAs/SM {occ}")
    return rows


def k5_name(hier, n, batch, word=64, scheme="exact"):
    """The launch name of K5 in the split of `batch` transforms of degree
    n: its form by the rule, its word, its scheme."""
    log_d = (n // hier.LOCAL_N).bit_length() - 1
    form = hier.cross_form(log_d, hier.LOG_LOCAL, batch, word, scheme)
    return hier.kernel_name(hier.CROSS_FORMS[form], word, scheme)


@contextlib.contextmanager
def forced_cross_form(hier, form):
    """hier.cross runs K5 in `form` instead of `hier.cross_form`'s pick (a
    tree without the rule has the column form alone)."""
    choose = getattr(hier, "cross_form", None)
    if choose is None:
        if form != "column":
            raise ValueError(f"this tree's K5 has no form {form}")
        yield
        return
    hier.cross_form = lambda *args: form
    try:
        yield
    finally:
        hier.cross_form = choose


def k5_times(root: pathlib.Path = ROOT, log_ds=range(1, 7), words=(64, 32),
             only=None) -> int:
    """`--k5-times [ROOT LOG_DS WORDS FORM]`: build the port at ROOT and
    print `k5_table`'s rows (at the given log2 D and words, in one form or
    in every form), with the card's name and power limit; the last line
    is the rows as JSON."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    log(card)
    sm_mhz = float(nvidia_smi("clocks.max.sm").splitlines()[0].split()[0])
    import_port(root)
    from hexl_tpu_torch import _build, nt
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import get_plan, hier
    probes = start_sass_probes(_build.nvcc_path(),
                               _build.BUILD_ROOT / "sass_probes")
    info = _build.build_all()
    log(f"build: {info['seconds']:.1f} s")
    imads = sass_imads(*probes)
    shoup = {64: imads["mulhi64"] + 2 * imads["mullo64"],
             32: imads["mulhi32"] + 2 * imads["mullo32"]}
    imad_rate = SMS * INT32_LANES_PER_SM * sm_mhz * 1e6

    def bound(nbytes, nops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / imad_rate * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    resources = _build.kernel_resources(info["log"])
    k5 = {k: v for k, v in resources.items() if K5_KERNEL.search(k)}
    spilled = {k: v for k, v in k5.items() if v[2] or v[3] or v[2] is None}
    log(f"build: {len(k5)} K5 instantiations, spills: {spilled}")
    rows = k5_table(np.random.default_rng(SEED), torch.device("cuda", 0),
                    nt, get_plan, hier, to_tensor, resources, shoup, bound,
                    log_ds, words, only)
    log(card)
    print(json.dumps({"card": card, "imads": imads, "rows": rows}))
    return 0


# Variants of K5's tiled form timed against each other: (threads, log2 of
# a tile's coefficients, ring buffers, CTAs per SM at most: 0 for as many
# as fit, -1 for one CTA a tile). "t128.c1k.r3.s2" is the source's.
K5_VARIANTS = {
    "t256.c2k.r3": (256, 11, 3, 0), "t256.c2k.r2": (256, 11, 2, 0),
    "t256.c2k.r4": (256, 11, 4, 0), "t512.c2k.r2": (512, 11, 2, 0),
    "t128.c1k.r3": (128, 10, 3, 0), "t256.c1k.r4": (256, 10, 4, 0),
    "t256.c4k.r2": (256, 12, 2, 0), "t512.c4k.r2": (512, 12, 2, 0),
    "t128.c1k.r2.s4": (128, 10, 2, 4), "t128.c1k.r2.s2": (128, 10, 2, 2),
    "t256.c1k.r2.s2": (256, 10, 2, 2), "t128.c1k.r1.one": (128, 10, 1, -1),
    "t256.c2k.r1.one": (256, 11, 1, -1), "t128.c1k.r3.s2": (128, 10, 3, 2),
    "t128.c1k.r4.s2": (128, 10, 4, 2), "t128.c1k.r3.s3": (128, 10, 3, 3),
    "t128.c1k.r2.s1": (128, 10, 2, 1), "t128.c1k.r4.s1": (128, 10, 4, 1),
    "t256.c2k.r2.s1": (256, 11, 2, 1)}


def k5_variants() -> int:
    """`--k5-variants`: copies of the port under build/exp/ with K5's tiled
    form at each of K5_VARIANTS' constants (and ntt_hier.cu alone to
    build), built at once, then `--k5-times` on each in its own process at
    D = 32 and 64 (u64) and D = 64 (u32), in turns (the list, then
    backwards); each row's times over both turns."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    log(nvidia_smi("name,power.limit"))
    roots = {}
    for name, (threads, log_tile, ring, per_sm) in K5_VARIANTS.items():
        root = ROOT / "build" / "exp" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(ROOT / "hexl_tpu_torch", root / "hexl_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for src in (root / "hexl_tpu_torch" / "csrc").glob("*.cu"):
            if src.name != "ntt_hier.cu":
                src.unlink()
        for rel, subs in (
                ("csrc/cross_tile.cuh",
                 ((r"TILE_THREADS = \d+", f"TILE_THREADS = {threads}"),
                  (r"LOG_TILE = \d+", f"LOG_TILE = {log_tile}"),
                  (r"TILE_RING = \d+", f"TILE_RING = {ring}"),
                  (r"TILE_CTAS_PER_SM = -?\d+",
                   f"TILE_CTAS_PER_SM = {per_sm}"))),
                ("ntt/hier.py", ((r"TILE_COEFFS = \d+",
                                  f"TILE_COEFFS = {1 << log_tile}"),))):
            path = root / "hexl_tpu_torch" / rel
            text = path.read_text()
            for pattern, repl in subs:
                text, count = re.subn(pattern, repl, text)
                if count != 1:
                    raise AssertionError(f"{name}: {pattern} in {rel}")
            path.write_text(text)
        roots[name] = root
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from hexl_tpu_torch import _build; _build.build_all()", str(root)])
        for root in roots.values()]
    if any(b.wait() for b in builds):
        return 1
    times = {}
    for name in list(roots) + list(roots)[::-1]:
        for words, log_ds in (("64", "5,6"), ("32", "6")):
            proc = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--k5-times",
                 str(roots[name]), log_ds, words, "tile"],
                capture_output=True, text=True, timeout=600)
            if proc.returncode:
                log(proc.stdout[-3000:], proc.stderr[-3000:])
                return 1
            for row in json.loads(proc.stdout.strip().splitlines()[-1])[
                    "rows"]:
                key = (name, row["word"], row["D"])
                times.setdefault(key, []).append(row)
    for (name, word, d), rows in times.items():
        ms = [r["ms"] for r in rows]
        log(f"K5 variant {name} word {word} D={d}: {ms} ms, share "
            f"{rows[0]['bound_ms'] / statistics.median(ms):.1%}, registers "
            f"{rows[0]['registers']}, CTAs/SM {rows[0]['ctas_per_sm']}")
    return 0


# Forms of K6 for a DistNTT position's small shards (L = 2^11 .. 2^13) at
# or near a full wave, each a copy of the port under build/exp/<name>/
# (ntt_hier.cu alone to build) with `subs` applied to a file: "base" is
# this tree's form (a group of R = 8 a thread: 256 threads at 2^11, 512
# at 2^12); "r4" cuts the same walk into groups of R = 4 at 2^11 and 2^12
# (512 and 1024 threads, six and six passes in place of four and four).
# Timed in turns by `shard_variants` at SHARD_VARIANT_ROWS (log L, shards
# D, batch): DistNTT at bench.py's shape on (1, 8) and (2, 4), and the
# 2^14 local pass of the split as a row the variants leave alone.
_LOCAL_SHAPE = """// The local pass of a shard (log_d > 0) of 2^11 or 2^12 in u64: groups
// of R = 2^%(logr)d, %(g)d a thread.
template <typename W, typename F>
static int with_local_shape(int log_n, int log_d, bool two_per_sm, F&& f) {
  if constexpr (sizeof(W) == 8) {
    if (log_d > 0 && log_n == 11)
      return f(Index<%(logr)d>{}, Index<%(g)d>{}, Index<11>{});
    if (log_d > 0 && log_n == 12)
      return f(Index<%(logr)d>{}, Index<%(g)d>{}, Index<12>{});
  }
  return with_shape<W>(log_n, two_per_sm, f);
}

"""


def _local_shape_subs(logr: int, g: int) -> tuple:
    """The substitutions of a variant whose small shards take groups of
    2^logr, g a thread (`_LOCAL_SHAPE`)."""
    return (("csrc/ntt_block.cuh",
             r"(    return with_)shape<W>\(log_n, two_per_sm,",
             r"\1local_shape<W>(log_n, log_d, two_per_sm,", 2),
            ("csrc/ntt_block.cuh", r"(// The SMs of the current device)",
             (_LOCAL_SHAPE % {"logr": logr, "g": g}) + r"\1", 1))


SHARD_VARIANTS = {"base": (), "r4": _local_shape_subs(2, 1),
                  "g2": _local_shape_subs(3, 2)}
SHARD_VARIANT_ROWS = ((11, 8, 256), (12, 4, 128), (14, 8, 16))


def shard_variant_times(root: pathlib.Path) -> int:
    """`--shard-variant-times ROOT`: build the port at ROOT and print, as
    one JSON line, the device ms of K6's forward (OMF 1) + inverse at each
    of SHARD_VARIANT_ROWS (position D/2 - 1 of D, a 60-bit prime; 20 graph
    replays of 20 calls on inputs rotating beyond the L2), after holding
    each against its plain version."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    import_port(root)
    from hexl_tpu_torch import _build, nt
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import get_plan, hier
    info = _build.build_all()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    out = {"build_s": info["seconds"],
           "resources": {k: v for k, v in _build.kernel_resources(
               info["log"]).items() if "radix" in k}}
    for log_l, d, batch in SHARD_VARIANT_ROWS:
        n = d << log_l
        plan = get_plan(n, nt.generate_primes(1, 60, True, ntt_size=n)[0])
        args = (log_l, d.bit_length() - 1, d // 2 - 1, 0)
        sets = [tuple(to_tensor(rng.integers(0, f * plan.q, size=(
            batch, 1 << log_l), dtype=np.uint64), dev) for f in (4, 2))
            for _ in range(max(2, (96 << 20) // (16 * batch << log_l)))]
        xf, xi = sets[0]
        for forward, x in ((True, xf), (False, xi)):
            got = hier.local_launch(x, plan, forward, 1, *args)
            torch.cuda.synchronize()
            if not torch.equal(got, hier.local_launch_plain(
                    x, plan, forward, 1, *args)):
                raise AssertionError(f"K6 at {root.name} L=2^{log_l} "
                                     f"forward={forward} != plain")
        nxt = rotating(sets)

        def pair(nxt=nxt, plan=plan, args=args):
            xf, xi = nxt()
            return (hier.local_launch(xf, plan, True, 1, *args),
                    hier.local_launch(xi, plan, False, 1, *args))
        out[f"n{log_l}.d{d}.b{batch}"] = graph_times(pair, 20)
    print(json.dumps(out))
    return 0


def shard_variants(names=tuple(SHARD_VARIANTS)) -> int:
    """`--shard-variants`: copies of the port under build/exp/ with each of
    SHARD_VARIANTS' forms (ntt_hier.cu alone to build), built at once,
    then `--shard-variant-times` on each in its own process, in turns
    (the list, then backwards); each row's median, spread and ratio to
    "base" over both turns."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    log(card)
    roots = {}
    for name in names:
        root = ROOT / "build" / "exp" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(ROOT / "hexl_tpu_torch", root / "hexl_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for src in (root / "hexl_tpu_torch" / "csrc").glob("*.cu"):
            if src.name != "ntt_hier.cu":
                src.unlink()
        for rel, pattern, repl, want in SHARD_VARIANTS[name]:
            path = root / "hexl_tpu_torch" / rel
            text, count = re.subn(pattern, repl, path.read_text())
            if count != want:
                raise AssertionError(f"{name}: {pattern} in {rel} {count}x")
            path.write_text(text)
        roots[name] = root
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from hexl_tpu_torch import _build; _build.build_all()", str(root)])
        for root in roots.values()]
    if any(b.wait() for b in builds):
        return 1
    times, resources = {}, {}
    for name in list(roots) + list(roots)[::-1]:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--shard-variant-times", str(roots[name])],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            log(proc.stdout[-3000:], proc.stderr[-3000:])
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        resources[name] = got.pop("resources")
        got.pop("build_s")
        for row, v in got.items():
            times.setdefault(row, {}).setdefault(name, []).extend(v)
    for name, res in resources.items():
        log(f"shard variant {name}: radix instantiations (registers, stack, "
            f"spill stores, spill loads) {res}")
    summary = {}
    for row, by in times.items():
        base = statistics.median(by["base"])
        summary[row] = {name: {"median": statistics.median(v),
                               "min": min(v), "max": max(v),
                               "over_base": statistics.median(v) / base}
                        for name, v in by.items()}
        log(f"shard variants {row}: " + "; ".join(
            f"{name} {r['median']:.4f} ms [{r['min']:.4f}, {r['max']:.4f}] "
            f"{r['over_base']:.3f}x" for name, r in summary[row].items()))
    log(card)
    log(json.dumps({"shard_variants": summary, "card": card}))
    return 0


def walk_times(root: pathlib.Path) -> int:
    """`--walk-times ROOT`: build the port at ROOT and print, as one JSON
    line, the device ms of each row of `walk_runs` (with the fifth path's
    rows) and of `stream_runs` in 20 graph replays of 20 calls each (of one
    call for the fifth path's calls), and the stream rows' bytes."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    import_port(root)
    from hexl_tpu_torch import _build, nt
    from hexl_tpu_torch import config as port_config
    from hexl_tpu_torch.eltwise import ops
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import cuda_ntt, get_plan, hier, shard
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    _build.build_all()
    rng, dev = np.random.default_rng(SEED), torch.device("cuda", 0)
    runs = walk_runs(rng, dev, nt, get_plan, cuda_ntt, hier, shard,
                     to_tensor, True)
    times = {name: graph_times(fn, 1 if name.startswith("fifth") else 20)
             for name, fn in runs.items()}
    del runs
    stream = stream_runs(rng, dev, nt, ops, ks, port_config, to_tensor)
    times.update({name: graph_times(fn, 20)
                  for name, (fn, _) in stream.items()})
    print(json.dumps({"times": times, "bytes": {
        name: nbytes for name, (_, nbytes) in stream.items()}}))
    return 0


def stream_times(root: pathlib.Path) -> int:
    """`--stream-times ROOT`: build the port at ROOT and print, as one JSON
    line, the device ms of each row of `stream_runs` in 20 graph replays
    of 20 calls each, and each row's bytes."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    import_port(root)
    from hexl_tpu_torch import _build, nt
    from hexl_tpu_torch import config as port_config
    from hexl_tpu_torch.eltwise import ops
    from hexl_tpu_torch.limb import to_tensor
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    _build.build_all()
    runs = stream_runs(np.random.default_rng(SEED), torch.device("cuda", 0),
                       nt, ops, ks, port_config, to_tensor)
    print(json.dumps({"times": {name: graph_times(fn, 20)
                                for name, (fn, _) in runs.items()},
                      "bytes": {name: nbytes
                                for name, (_, nbytes) in runs.items()}}))
    return 0


# The cluster form's rule (`rns.cluster_for`): the forward + inverse pair of
# one 50-bit prime through the public wrappers at N = 2^12 .. 2^15 and the
# batches below, each C forced (1: the one-CTA form; a C whose clusters the
# card cannot hold all at once is skipped), and the split variant at L =
# 2^10 and 2^11 (`split_variant`) beside them; one-CTA grids from 1 CTA to
# a wave (N = 2^15: two shards a transform).
CLUSTER_TIME_BATCHES = (1, 2, 3, 4, 6, 8, 12, 16, 20, 24, 28, 32, 48, 56, 64,
                        96, 128)


def cluster_times(root: pathlib.Path = ROOT,
                  batches=CLUSTER_TIME_BATCHES) -> int:
    """`--cluster-times [ROOT BATCHES]`: build the port (at ROOT, a variant
    tree), report the cluster form's instantiations (registers and
    spills), hold K1.rns.cl and K6.rns.cl bit-exact against the plain
    cluster walk (`cluster_kernel_checks`; this tree only), time the
    launch floor (the empty kernel, and one of two cluster barriers, at a
    cluster's grid), then print the device ms of the pair at every (N,
    batch, C) and the split variant's (median of 20 graph replays of 10
    calls), each grid's fastest, and the rows as one JSON line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    log(card)
    import_port(root)
    from hexl_tpu_torch import _build, nt
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import cuda_ntt, get_plan, hier, rns, torch_ntt
    info = _build.build_all()
    resources = _build.kernel_resources(info["log"])
    cl = {k: v for k, v in resources.items()
          if CLUSTER_INSTANTIATION.search(k)}
    log(f"build: {info['seconds']:.1f} s; {len(cl)} cluster-form "
        f"instantiations (registers, stack, spill stores, spill loads): {cl}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    bad = []

    def compare(kernel, got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad.append(what)
    if root == ROOT:
        checks = cluster_kernel_checks(rng, dev, nt, rns, cuda_ntt, get_plan,
                                       torch_ntt, to_tensor, compare,
                                       _build.launches)
        log(f"cluster checks: {checks - len(bad)} of {checks} bit-exact; "
            f"mismatches {bad[:20]}")
    launch_empty = empty_probe(*start_empty_probe(
        _build.nvcc_path(), _build.BUILD_ROOT / "sass_probes"))
    for log_n in (12, 14):
        for c in (1,) + CLUSTER_SIZES:
            threads = min(1024, (1 << log_n) // (8 * c))
            floors = [statistics.median(graph_times(
                lambda: launch_empty(c, threads, c, (8 << log_n) // c,
                                     syncs), 20)) for syncs in (0, 2)]
            log(f"cluster floor N=2^{log_n} C={c} ({threads} threads): "
                f"empty {floors[0]:.4f} ms, two cluster barriers "
                f"{floors[1]:.4f} ms")
    sms = cuda_ntt.sm_count(dev)
    log("most active clusters: " + ", ".join(
        f"N=2^{ln} C={c} {rns.max_active_clusters(ln, c, dev)}"
        for ln in (12, 13, 14) for c in CLUSTER_SIZES))
    out = {}
    for log_n in (12, 13, 14, 15):
        n = 1 << log_n
        shards = max(1, n >> hier.LOG_LOCAL)
        plan = get_plan(n, nt.generate_primes(1, 50, True, ntt_size=n)[0])
        for batch in batches:
            ctas = batch * shards
            if ctas >= sms:
                continue
            x = to_tensor(rng.integers(0, plan.q, size=(batch, n),
                                       dtype=np.uint64), dev)
            row = {}
            for c in (1,) + CLUSTER_SIZES:
                if c > 1 and rns.max_active_clusters(
                        min(log_n, hier.LOG_LOCAL), c, dev) < ctas:
                    continue
                with forced_clusters(rns, c):
                    row[f"C{c}"] = statistics.median(graph_times(
                        lambda: cuda_ntt.inv_ntt(cuda_ntt.fwd_ntt(x, plan),
                                                 plan), 10))
            for log_l in (10, 11):
                if 1 << log_l < n and n >> log_l <= 64:
                    with forced_clusters(rns, 1):
                        row[f"L{log_l}"] = statistics.median(graph_times(
                            lambda: split_variant(split_variant(
                                x, plan, True, 1, log_l, hier, rns,
                                torch_ntt), plan, False, 1, log_l, hier, rns,
                                torch_ntt), 10))
            best = min(row, key=row.get)
            out[f"n{log_n}.b{batch}"] = {"ctas": ctas, "ms": row,
                                         "best": best}
            log(f"cluster N=2^{log_n} batch={batch} ({ctas} one-CTA CTAs): "
                + " ".join(f"{k}={v:.4f}" for k, v in row.items())
                + f"; best {best}, C1/best {row['C1'] / row[best]:.2f}")
    log(card)
    print(json.dumps(out))
    return 0 if not bad else 1


# A DistNTT position's local pass (row 10, K6.shard) at every shape the
# fifth path launches it (`fifth_local_shapes`): L = 2^14 at one shard and
# L = 2^15 as two sub-shards (the RNS product on (2, 8) and (2, 4)), L =
# 2^11 x 256 and 2^12 x 128 (DistNTT at bench.py's shape on (1, 8) and
# (2, 4)), L = 2^12 at batches 1-3 (the key switch on (2, 4)).
def fifth_local_shapes(calls, shard) -> dict:
    """{(N, D, batch, forward, omf): [plan, position, calls]} of every
    `shard.local` that one run of each fifth-path call makes (the plan
    and position of its first)."""
    import torch
    seen = {}
    local = shard.local

    def recording(x, plan, r, shards, forward, omf=1, *scheme):
        key = (plan.n, shards, x.numel() // x.shape[-1], forward, omf)
        seen.setdefault(key, [plan, r, 0])[2] += 1
        return local(x, plan, r, shards, forward, omf, *scheme)

    shard.local = recording
    try:
        for call, _, _ in calls.values():
            call()
        torch.cuda.synchronize()
    finally:
        shard.local = local
    return seen


def local_grid(log_n: int, chunks: int, clusters: int = 1) -> tuple:
    """(CTAs, threads a CTA) of the local pass on `chunks` chunks of
    2^log_n: the one-CTA walk (ntt_block.cuh with_shape: a group of 8 a
    thread, two at 2^14) or a cluster of C CTAs a chunk (a group a
    thread on each CTA's 2^log_n / C)."""
    if clusters == 1:
        return chunks, (1 << log_n) // (16 if log_n == 14 else 8)
    return chunks * clusters, (1 << log_n) // (8 * clusters)


def local_pass_runs(rng, dev, shard, hier, shapes) -> dict:
    """{row: (fn, facts)} for each shape of `fifth_local_shapes`: the local
    pass of position r through `shard.local` on inputs that rotate (beyond
    the L2 where a shape's input is large), and above 2^14 its sub-shard
    launch alone (`shard.local_chunks` where the tree has it, else K6's
    `hier.local_launch`, which take the same arguments)."""
    import numpy as np
    from hexl_tpu_torch.limb import to_tensor
    chunks_of = getattr(shard, "local_chunks", hier.local_launch)
    runs = {}
    for (n, d, batch, forward, omf), (plan, r, count) in sorted(
            shapes.items(), key=lambda kv: kv[0]):
        length = n // d
        rows = max(1, length >> hier.LOG_LOCAL)
        log_l = min(length, hier.LOCAL_N).bit_length() - 1
        sets = max(2, min(8, (64 << 20) // (8 * batch * length)))
        bound = (4 if forward else 2) * plan.q
        nxt = rotating([to_tensor(rng.integers(
            0, bound, size=(batch, length), dtype=np.uint64), dev)
            for _ in range(sets)])
        name = (f"K6.shard N=2^{n.bit_length() - 1}/{d} x{batch} "
                f"{'fwd' if forward else 'inv'}{omf}")
        facts = {"N": n, "D": d, "L": length, "batch": batch,
                 "forward": forward, "omf": omf, "launches": count,
                 "log_chunk": log_l, "chunks": batch * rows}
        runs[name] = (lambda nxt=nxt, plan=plan, r=r, d=d, f=forward,
                      o=omf: shard.local(nxt(), plan, r, d, f, o), facts)
        if rows > 1:
            log_d = d.bit_length() - 1 + rows.bit_length() - 1
            runs[name + " sub-shards"] = (
                lambda nxt=nxt, plan=plan, r=r, rows=rows, log_d=log_d,
                f=forward, o=omf: chunks_of(nxt(), plan, f, o, hier.LOG_LOCAL,
                                            log_d, r * rows,
                                            rows.bit_length() - 1),
                dict(facts, sub_shards=True))
    return runs


def shard_times(root: pathlib.Path = ROOT) -> int:
    """`--shard-times [ROOT]`: build the port (at ROOT, e.g. a parent
    tree), record every local pass of the fifth path (`fifth_local_shapes`)
    and print the device ms of each shape and direction (median of 20
    graph replays of 20 calls) with its launches on the path, its one-CTA
    grid and threads and, where the tree routes the pass to the cluster
    form (`shard.local_chunks`), each C the card holds forced; then each
    fifth-path call replayed from a CUDA graph (median of 20 replays) with
    its launches by kernel; the rows as one JSON line."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    log(card)
    import_port(root)
    from hexl_tpu_torch import _build, nt
    from hexl_tpu_torch.ntt import cuda_ntt, hier, rns, shard
    probe_dir = _build.BUILD_ROOT / "sass_probes"
    probes = start_sass_probes(_build.nvcc_path(), probe_dir)
    empty = start_empty_probe(_build.nvcc_path(), probe_dir)
    info = _build.build_all()
    log(f"build: {info['seconds']:.1f} s")
    imads, launch_empty = sass_imads(*probes), empty_probe(*empty)
    per_shoup = imads["mulhi64"] + 2 * imads["mullo64"]
    sm_mhz = float(nvidia_smi("clocks.max.sm").splitlines()[0].split()[0])
    imad_rate = SMS * INT32_LANES_PER_SM * sm_mhz * 1e6
    dev = torch.device("cuda", 0)
    sms = cuda_ntt.sm_count(dev)
    rng = np.random.default_rng(SEED)
    moduli = nt.generate_primes(RNS_PRIMES, 50, True, ntt_size=1 << 17)
    f5 = fifth_path(rng, dev, moduli)
    shapes = fifth_local_shapes(f5.calls, shard)
    routed = hasattr(shard, "local_chunks")
    out = {"card": card, "local": {}, "calls": {}}
    if routed:
        log("most active clusters: " + ", ".join(
            f"2^{ln} C={c} {rns.max_active_clusters(ln, c, dev)}"
            for ln in (12, 13, 14) for c in CLUSTER_SIZES))
    for name, (fn, facts) in local_pass_runs(rng, dev, shard, hier,
                                             shapes).items():
        log_l, chunks = facts["log_chunk"], facts["chunks"]
        row = dict(facts, ms=statistics.median(graph_times(fn, 20)))
        row["rule_C"] = (rns.cluster_for(log_l, chunks, sms, dev)
                         if routed and log_l >= 12 else 1)
        row["ctas"], row["threads"] = local_grid(log_l, chunks, row["rule_C"])
        # The bound of one launch of K6 (or of its cluster) on the pass's
        # chunks: each coefficient read and written once, the shard's
        # twiddles and their preconditions once; one Shoup product a
        # butterfly; no less than the empty probe at the launch's grid.
        if facts["L"] == 1 << log_l or facts.get("sub_shards"):
            length, c = 1 << log_l, row["rule_C"]
            nbytes = 16 * chunks * length + 16 * (length - 1)
            nops = log_l * chunks * (length // 2) * per_shoup
            floor = statistics.median(graph_times(
                lambda: launch_empty(row["ctas"], row["threads"]) if c == 1
                else launch_empty(row["ctas"], row["threads"], c,
                                  8 * length // c), 20))
            got = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                   "operations": nops / imad_rate * 1e3,
                   "launch floor": floor}
            row["bound_by"] = max(got, key=got.get)
            row["bound_ms"] = got[row["bound_by"]]
        if routed and log_l >= 12:
            for c in (1,) + CLUSTER_SIZES:
                if c > 1 and rns.max_active_clusters(log_l, c, dev) < chunks:
                    continue
                with forced_clusters(rns, c):
                    row[f"C{c}"] = statistics.median(graph_times(fn, 20))
        out["local"][name] = row
        log(f"{name}: {row['ms']:.4f} ms, {row['launches']} launches on the "
            f"fifth path, {row['ctas']} CTAs of {row['threads']} threads "
            f"(C={row['rule_C']})" + (
                f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['bound_ms'] / row['ms']:.1%}" if "bound_ms" in row
                else "") + "".join(
                f", C{c} {row[f'C{c}']:.4f}" for c in (1,) + CLUSTER_SIZES
                if f"C{c}" in row))
    for name, (call, _, _) in f5.calls.items():
        _build.reset_launches()
        call()
        torch.cuda.synchronize()
        launched = dict(_build.launches)
        ms = statistics.median(graph_times(call, 1))
        out["calls"][name] = {"replayed_ms": ms, "launches": launched}
        log(f"fifth path {name}: {ms:.4f} ms replayed, launches {launched}")
    log(card)
    print(json.dumps(out))
    return 0


def turns_of(order, flag: str):
    """Run `chip_smoke.py FLAG ROOT` for each (label, root) of `order` in
    turn, each in its own process: ({label: [{row: [ms, ...]} per turn]},
    {row: bytes}), or None where a turn failed."""
    turns, nbytes = {}, {}
    for label, root in order:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag,
             str(root.resolve())], capture_output=True, text=True,
            timeout=900)
        if proc.returncode:
            log(proc.stdout[-4000:], proc.stderr[-4000:])
            return None
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.setdefault(label, []).append(out["times"])
        nbytes.update(out["bytes"])
    return turns, nbytes


def ab_summary(turns: dict, nbytes: dict, base: str, what: str) -> dict:
    """Each row's median [min, max] over every label's turns, the median of
    each turn (in the order run), the ratio to `base`'s median and, where
    the row's bound is its bytes, each label's share of that bound; logged
    a row a line and returned."""
    summary = {}
    rows = []
    for label_turns in turns.values():
        for turn in label_turns:
            rows += [r for r in turn if r not in rows]
    for row in rows:
        entry = {}
        for label, label_turns in turns.items():
            pooled = [v for turn in label_turns for v in turn.get(row, [])]
            if not pooled:
                continue
            med = statistics.median(pooled)
            entry[label] = {"median": med, "min": min(pooled),
                            "max": max(pooled),
                            "turns": [statistics.median(t[row])
                                      for t in label_turns if row in t]}
            if row in nbytes:
                entry[label]["share"] = (nbytes[row] / HBM_BYTES_PER_S * 1e3
                                         / med)
            if label != base and base in entry:
                entry[label]["over_" + base] = med / entry[base]["median"]
        summary[row] = entry
        log(f"{what} {row}: " + "; ".join(
            f"{label} {v['median']:.4f} ms [{v['min']:.4f}, {v['max']:.4f}]"
            f" turns {', '.join(f'{m:.4f}' for m in v['turns'])}"
            + (f", {v['share']:.1%} of bytes bound" if "share" in v else "")
            + (f", {v['over_' + base]:.3f}x {base}"
               if "over_" + base in v else "")
            for label, v in entry.items()))
    return summary


def walk_ab(parent: pathlib.Path) -> int:
    """`--walk-ab PARENT`: the walk rows (`walk_runs`, `stream_runs`) of the
    port at PARENT (a `git archive` of an earlier commit) against this
    tree's, on one card, in turns parent, this tree, this tree, parent
    (`walk_times` in a process each), with each side's median, spread and
    per-turn medians over its 40 replays, and the stream rows' shares of
    their bytes bound."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    log(card)
    result = turns_of((("parent", parent), ("new", ROOT), ("new", ROOT),
                       ("parent", parent)), "--walk-times")
    if result is None:
        return 1
    summary = ab_summary(*result, "parent", "A/B")
    log(card)
    log(json.dumps({"walk_ab": summary, "card": card}))
    return 0


# Variants of the streaming kernels' redesign, each a copy of the port
# under build/exp/<name>/ (eltwise.cu and key_switch.cu alone to build)
# with each (pattern, replacement) applied once to those sources; a
# variant may set knobs of both kernels, whose rows are timed apart.
# "base" is this tree's (eltwise: four 16-byte accesses a trip for a body
# that reads one operand, one for a body that reads two, 128 threads, one
# wave, loads through the read-only path (__ldg), plain stores; K10: 128
# threads, j groups of 4, evict-first loads). "u4": four accesses for
# every body; "u1": one for every body; "t256": eltwise CTAs of 256
# threads; "t64": of 64 (twice the CTAs of 128 under a wave); "k256": K10
# CTAs of 256 threads; "j2": K10's j groups of 2; "cs": the eltwise
# 16-byte loads and stores marked as touched once (__ldcs/__stcs,
# evict-first); "kldg": K10's 16-byte loads through the read-only path.
ELTWISE_CS = ((r"__ldg\(reinterpret_cast<const ulonglong2\*>\(v\) \+ p\)",
               "__ldcs(reinterpret_cast<const ulonglong2*>(v) + p)"),
              (r"reinterpret_cast<ulonglong2\*>\(v\)\[p\] = x;",
               "__stcs(reinterpret_cast<ulonglong2*>(v) + p, x);"))
STREAM_VARIANTS = {
    "base": (),
    "u4": ((r"UNROLL_TWO_INPUTS = 1;", "UNROLL_TWO_INPUTS = 4;"),),
    "u1": ((r"UNROLL_ONE_INPUT = 4;", "UNROLL_ONE_INPUT = 1;"),),
    "t256": ((r"\bTHREADS = 128;", "THREADS = 256;"),),
    "t64": ((r"\bTHREADS = 128;", "THREADS = 64;"),),
    "k256": ((r"MAC_THREADS = 128;", "MAC_THREADS = 256;"),),
    "j2": ((r"MAC_J = 4;", "MAC_J = 2;"),),
    "cs": ELTWISE_CS,
    "kldg": ((r"__ldcs\(reinterpret_cast<const ulonglong2\*>\(row\) \+ p\)",
              "__ldg(reinterpret_cast<const ulonglong2*>(row) + p)"),),
}
STREAM_SOURCES = ("eltwise.cu", "key_switch.cu")


def stream_copy(src: pathlib.Path, name: str, subs=()) -> pathlib.Path:
    """The port at `src` copied to build/exp/<name>/ with only
    STREAM_SOURCES left to build, each substitution applied once."""
    root = ROOT / "build" / "exp" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src / "hexl_tpu_torch", root / "hexl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = root / "hexl_tpu_torch" / "csrc"
    for path in csrc.glob("*.cu"):
        if path.name not in STREAM_SOURCES:
            path.unlink()
    for pattern, repl in subs:
        hits = 0
        for name_ in STREAM_SOURCES:
            path = csrc / name_
            text, count = re.subn(pattern, repl, path.read_text())
            hits += count
            path.write_text(text)
        if hits != 1:
            raise AssertionError(f"{name}: {pattern} matched {hits} times")
    return root


def stream_variants(parent=None, rounds=1, names=None) -> int:
    """`--stream-variants [PARENT [ROUNDS [NAMES]]]`: STREAM_VARIANTS'
    copies of this tree (those of the comma-separated NAMES, default all;
    and PARENT's sources, as "parent", first), built at once, then
    `--stream-times` on each in its own process in turns (the list, then
    backwards, ROUNDS times, default once): each row's medians, per-turn
    medians, ratio to the first and share of the bytes bound, with each
    copy's -Xptxas -v report of the two kernels."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    log(card)
    roots = {}
    if parent is not None:
        roots["parent"] = stream_copy(parent, "parent")
    for name in names or STREAM_VARIANTS:
        roots[name] = stream_copy(ROOT, name, STREAM_VARIANTS[name])
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from hexl_tpu_torch import _build; r = _build.kernel_resources("
         "_build.build_all()['log']); print({k: v for k, v in r.items() "
         "if 'eltwise' in k or 'mac_flush' in k})", str(root)],
        stdout=subprocess.PIPE, text=True) for root in roots.values()]
    for name, proc in zip(roots, builds):
        text, _ = proc.communicate()
        if proc.returncode:
            return 1
        log(f"stream variant {name} resources: {text.strip()}")
    order = list(roots.items())
    result = turns_of((order + order[::-1]) * rounds, "--stream-times")
    if result is None:
        return 1
    summary = ab_summary(*result, order[0][0], "stream")
    log(card)
    log(json.dumps({"stream_variants": summary, "card": card}))
    return 0


# -- the seventh main path: the host-side modules ------------------------------
# The cold start as `prewarm` measures it, at bench.py's shape, the second
# path's N = 2^17 and 2^20 transforms and the single-word 2^14 (degree,
# q bits, batch); the plan file; the example; a profiler trace.
SEVENTH_CONFIGS = ((1 << 14, 60, 256), (1 << 17, 60, 16), (1 << 20, 60, 2),
                   (1 << 14, 29, 256))
SEVENTH_RESULT = "seventh-result: "
PREWARM_KERNELS = ("K1", "K5", "K5.tile", "K6", "K7", "K14", "K15")
EXAMPLE_KERNELS = ("K1", "K1.rns", "K2", "K3", "K4", "K4.rows", "K5", "K6",
                   "K7", "K9", "K10", "K11", "K12.f64", "K13.f64")
TRACE_CALLS = 20
TRACE_KEY_SWITCH = (1 << 15, 14)   # (N, ds): the third path's largest


def seventh_child(task: str, arg: str, device: str) -> int:
    """One step of the seventh path in a fresh process on `device`, run as
    `chip_smoke.py --seventh-child TASK ARG DEVICE`; prints its result as
    one JSON line after SEVENTH_RESULT, with the process's kernel launches.

    prewarm: `prewarm` at each of SEVENTH_CONFIGS (backend "xla") and the
      MXU backend at 2^14, then the first public pair of each config;
    cold: the first public pair of each config in a process that was not
      prewarmed;
    save ARG: build the configs' plans and write them to the file ARG
      (host work only: the card is not touched);
    load ARG: load the file ARG, run the first pair of each config on the
      loaded plans, and hold each output against a freshly built plan's;
    example: examples/example_torch.py on the card.
    A first pair is NTT(n, q) constructed, forward and inverse,
    synchronised; five more of the same give the warm pair's median."""
    import runpy

    import numpy as np
    import torch

    import hexl_tpu_torch as port
    from hexl_tpu_torch import NTT, _build, native, nt
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import plan as plan_mod

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"task": task, "native": native.available()}
    qs = [nt.generate_primes(1, bits, True, ntt_size=n)[0]
          for n, bits, _ in SEVENTH_CONFIGS]

    def first_pairs():
        rng = np.random.default_rng(SEED)
        xs = [to_tensor(rng.integers(0, q, size=(batch, n), dtype=np.uint64),
                        dev) for (n, _, batch), q in zip(SEVENTH_CONFIGS, qs)]
        sync()
        first, warm, ys = [], [], []
        for (n, _, _), q, x in zip(SEVENTH_CONFIGS, qs, xs):
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                e = NTT(n, q, device=dev)
                y = e.forward(x)
                back = e.inverse(y)
                sync()
                times.append(time.perf_counter() - t0)
            if not torch.equal(back, x):
                raise AssertionError(f"first pair at N={n}, q={q}: round "
                                     "trip failed")
            first.append(times[0])
            warm.append(statistics.median(times[1:]))
            ys.append(y)
        out["first_s"], out["warm_s"] = first, warm
        return xs, ys

    if task == "prewarm":
        records = []
        for n, bits, batch in SEVENTH_CONFIGS:
            records += port.prewarm([(n, bits)], batch=batch, device=dev)
        n, bits, batch = SEVENTH_CONFIGS[0]
        records += port.prewarm([(n, bits)], batch=batch, backends=("mxu",),
                                device=dev)
        out["records"] = records
        first_pairs()
    elif task == "cold":
        first_pairs()
    elif task == "save":
        build = []
        for (n, _, _), q in zip(SEVENTH_CONFIGS, qs):
            t0 = time.perf_counter()
            plan_mod.get_plan(n, q)
            build.append(time.perf_counter() - t0)
        out["build_s"] = build
        out["saved"] = plan_mod.save_plan_cache(arg)
    elif task == "load":
        t0 = time.perf_counter()
        out["loaded"] = plan_mod.load_plan_cache(arg)
        out["load_s"] = time.perf_counter() - t0
        loaded = [plan_mod.get_plan(n, q)
                  for (n, _, _), q in zip(SEVENTH_CONFIGS, qs)]
        xs, ys = first_pairs()
        # The same first pair on freshly built plans, bit for bit.
        plan_mod.clear_plan_cache()
        for (n, _, _), q, x, y, old in zip(SEVENTH_CONFIGS, qs, xs, ys,
                                           loaded):
            e = NTT(n, q, device=x.device)
            if e.plan is old or not torch.equal(e.forward(x), y):
                raise AssertionError(f"loaded plan (N={n}, q={q}) != a "
                                     "freshly built one")
        out["equal_to_built"] = True
    elif task == "example":
        sys.argv = [str(ROOT / "examples" / "example_torch.py"), "--device",
                    device]
        runpy.run_path(sys.argv[0], run_name="__main__")
        sync()
    else:
        raise ValueError(f"unknown task {task!r}")
    out["launches"] = dict(_build.launches)
    print(SEVENTH_RESULT + json.dumps(out), flush=True)
    return 0


def run_seventh_child(task: str, arg: str, env, device) -> tuple:
    """(result dict, wall seconds, its other output) of one seventh_child
    process; raises if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--seventh-child", task,
         arg, str(device)], cwd=ROOT, env=dict(os.environ, **(env or {})),
        capture_output=True, text=True, timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"seventh path: {task} {env or ''} failed "
                             f"(rc {proc.returncode}):\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-6000:]}")
    lines = proc.stdout.splitlines()
    result = json.loads(lines[-1][len(SEVENTH_RESULT):])
    return result, wall, "\n".join(lines[:-1])


def trace_breakdown(path: str, calls: int) -> dict:
    """Per workload of a Chrome trace whose calls are ranges named
    "workload#i" (record_function, each ending in a synchronise), means
    over its calls: the wall time of a call, its device-busy time (the
    union of the kernel events it launched), the idle share 1 - busy/wall,
    the kernel launches, and the five host ops and ranges of the process
    with the most self time (self: own time less that of the events nested
    in it; "(python)" is the range's own, the interpreter between traced
    ops). A kernel belongs to the call whose range holds its launch (the
    runtime call with the same correlation id): the device clock's offset
    from the host's in the trace is tens of microseconds, as long as a
    short call. Times in microseconds."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    # A graph replay's kernels share its cudaGraphLaunch's correlation id.
    kernel_of = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel":
            kernel_of[e["args"]["correlation"]].append(
                (e["ts"], e["ts"] + e["dur"]))
    host = [e for e in events if e.get("cat") in (
        "cpu_op", "cuda_runtime", "user_annotation")]
    windows = [e for e in events if e.get("cat") == "user_annotation"
               and "#" in e["name"]]
    out = {}
    for w in windows:
        name = w["name"].split("#")[0]
        lo, hi = w["ts"], w["ts"] + w["dur"]
        stats = out.setdefault(name, {"wall": [], "busy": [], "launches": [],
                                      "self": collections.Counter()})
        nested = sorted((e for e in host if e["pid"] == w["pid"]
                         and lo <= e["ts"]
                         and e["ts"] + e["dur"] <= hi + 1e-3),
                        key=lambda e: (e["ts"], -e["dur"]))
        spans = sorted(k for c in (
            e.get("args", {}).get("correlation") for e in nested
            if e.get("cat") == "cuda_runtime") for k in kernel_of.get(c, ()))
        busy, reach = 0.0, float("-inf")
        for a, b in spans:
            if b > reach:
                busy += b - max(a, reach)
                reach = b
        stats["wall"].append(w["dur"])
        stats["busy"].append(busy)
        stats["launches"].append(len(spans))
        stack = []
        for e in nested:
            label = "(python)" if e is w else e["name"]
            while stack and stack[-1][1] <= e["ts"]:
                stack.pop()
            if stack:
                stats["self"][stack[-1][0]] -= e["dur"]
            stats["self"][label] += e["dur"]
            stack.append((label, e["ts"] + e["dur"]))
    for name, s in out.items():
        if len(s["wall"]) != calls:
            raise AssertionError(f"trace: {len(s['wall'])} calls of {name}, "
                                 f"expected {calls}")
        s["top"] = [(k, v / calls) for k, v in s["self"].most_common(5)]
        s["idle"] = 1 - sum(s["busy"]) / sum(s["wall"])
        s["wall_us"] = statistics.mean(s["wall"])
        s["busy_us"] = statistics.mean(s["busy"])
        s["launches_per_call"] = sum(s["launches"]) / calls
    return out


def seventh_path(rng, dev, compare) -> dict:
    """The seventh main path (see its comment in main); returns the
    launches of every process and call it ran."""
    import tempfile

    import numpy as np
    import torch

    import hexl_tpu_torch as port
    from hexl_tpu_torch import NTT, _build, native, nt
    from hexl_tpu_torch.eltwise import torch_kernels
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import torch_ntt
    from hexl_tpu_torch.utils.profiling import trace
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")

    if not native.available():
        raise AssertionError("seventh path: the host library is not "
                             "available on the card machine")
    launches = collections.Counter()
    t_path = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def child(task, arg="", env=None):
        result, wall, text = run_seventh_child(task, arg, env, dev)
        if text:
            log(text)
        launches.update(result["launches"])
        log(f"seventh path: {task}{' ' + str(env) if env else ''}: "
            f"{wall:.2f} s in its process; launches {result['launches']}")
        result["stdout"] = text
        return result

    # Cold start: prewarm in a fresh process (the nvcc build is on disk
    # from phase 2), then the first public pair of each config, against
    # the same first pair in a process that was not prewarmed.
    warm = child("prewarm")
    for n, q, backend, seconds in warm["records"]:
        log(f"prewarm record: n=2^{n.bit_length() - 1} q={q} [{backend}] "
            f"{seconds:.4f} s")
    cold = child("cold")
    for i, (n, bits, batch) in enumerate(SEVENTH_CONFIGS):
        log(f"first pair N=2^{n.bit_length() - 1} {bits}-bit batch {batch}: "
            f"prewarmed {warm['first_s'][i] * 1e3:.3f} ms, not prewarmed "
            f"{cold['first_s'][i] * 1e3:.3f} ms, warm pair "
            f"{warm['warm_s'][i] * 1e3:.3f} ms (prewarmed process), "
            f"{cold['warm_s'][i] * 1e3:.3f} ms (the other); prewarmed first "
            f"/ warm {warm['first_s'][i] / warm['warm_s'][i]:.2f}")
    # Where the cluster rule routes a config's one-CTA kernel (K1, K6) to
    # the cluster form, that form is what prewarm must have launched.
    from hexl_tpu_torch.ntt import cuda_ntt, rns
    routed = set()
    for n, bits, batch in SEVENTH_CONFIGS:
        if bits >= 30:
            routed.update(transform_launches(rns, cuda_ntt.sm_count(dev),
                                             dev, n, 1, batch, False))
    prewarm_kernels = ({k for k in PREWARM_KERNELS if k not in ("K1", "K6")}
                       | {k for k in routed if k != "K5"})
    missing = [k for k in sorted(prewarm_kernels)
               if warm["launches"].get(k, 0) < 1]
    if missing:
        raise AssertionError(f"seventh path: prewarm launched no {missing}")

    # The plan file: built and saved in one process, loaded and driven in
    # another, with the host library and without it.
    with tempfile.TemporaryDirectory() as tmp:
        for env, tag in ((None, "native"),
                         ({"HEXL_TPU_DISABLE_NATIVE": "1"}, "python")):
            path = os.path.join(tmp, f"plans_{tag}.npz")
            saved = child("save", path, env)
            loaded = child("load", path, env)
            if not saved["native"] == loaded["native"] == (tag == "native"):
                raise AssertionError(f"plan file ({tag}): native "
                                     f"{saved['native']}/{loaded['native']}")
            if not (saved["saved"] == loaded["loaded"] == len(
                    SEVENTH_CONFIGS) and loaded["equal_to_built"]):
                raise AssertionError(f"plan file ({tag}): {saved} {loaded}")
            log(f"plan file ({tag} tables): build "
                + ", ".join(f"N=2^{n.bit_length() - 1} {bits}-bit {s:.4f} s"
                            for (n, bits, _), s in zip(SEVENTH_CONFIGS,
                                                       saved["build_s"]))
                + f" (total {sum(saved['build_s']):.4f} s); load of all "
                f"{loaded['loaded']} {loaded['load_s']:.4f} s; file "
                f"{os.path.getsize(path)} bytes; first pairs on the loaded "
                "plans == on freshly built ones")

    # The example on the card.
    example = child("example")
    if not example["stdout"].endswith("All examples passed."):
        raise AssertionError("seventh path: the example did not pass")
    missing = [k for k in EXAMPLE_KERNELS
               if not any(name == k or name.startswith(k + ".")
                          for name in example["launches"])]
    if missing:
        raise AssertionError(f"seventh path: the example launched no "
                             f"{missing}")

    # The trace: utils.profiling.trace around TRACE_CALLS calls each of
    # the graft pipeline (2^12, 50-bit, batch 2), the key switch at
    # N = 2^15 x ds 14 and one eltwise_mult_mod at its Xeon row's shape
    # (2^13, 60-bit), each call a record_function range ending in a
    # synchronise; the same calls without the profiler, before and after
    # it, beside them (mean us of TRACE_CALLS, each synchronised).
    n12, n13 = 1 << 12, 1 << 13
    n15, ds = TRACE_KEY_SWITCH
    q50 = nt.generate_primes(1, 50, True, ntt_size=n12)[0]
    q60 = nt.generate_primes(1, 60, True, ntt_size=n13)[0]
    ga, gb = (to_tensor(rng.integers(0, q50, size=(2, n12), dtype=np.uint64),
                        dev) for _ in range(2))
    e12 = NTT(n12, q50, device=dev)
    ea, eb = (to_tensor(rng.integers(0, q60, size=n13, dtype=np.uint64), dev)
              for _ in range(2))
    result, t, keys, ks_moduli, msf = key_switch_inputs(
        rng, n15, (49,) * (ds + 1), 2, dev, nt, to_tensor)
    workloads = {
        "graft": lambda: e12.inverse(port.eltwise_mult_mod(
            e12.forward(ga, 1, 4), e12.forward(gb, 1, 4), q50, 4)),
        "key_switch": lambda: port.key_switch(result, t, n15, ds, ds + 1,
                                              ds + 1, 2, ks_moduli, keys, msf),
        "eltwise_mult_mod": lambda: port.eltwise_mult_mod(ea, eb, q60, 1),
    }
    plain = {
        "graft": lambda: torch_ntt.inv_ntt(torch_kernels.mult_mod(
            torch_ntt.fwd_ntt(ga, e12.plan, 1, 4),
            torch_ntt.fwd_ntt(gb, e12.plan, 1, 4), q50, 4), e12.plan),
        "key_switch": lambda: ks.key_switch_plain(
            result, t, n15, ds, ds + 1, ds + 1, 2, ks_moduli, keys, msf),
        "eltwise_mult_mod": lambda: torch_kernels.mult_mod(ea, eb, q60, 1),
    }
    kernel_of = {"graft": "K1", "key_switch": "K11", "eltwise_mult_mod": "K4"}

    def untraced():
        means = {}
        for name, fn in workloads.items():
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(TRACE_CALLS):
                fn()
                sync()
            means[name] = (time.perf_counter() - t0) / TRACE_CALLS * 1e6
        return means

    before = untraced()
    _build.reset_launches()
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as path:
            for fn in workloads.values():       # outside the ranges
                fn()
            sync()
            for name, fn in workloads.items():
                for i in range(TRACE_CALLS):
                    with torch.profiler.record_function(f"{name}#{i}"):
                        outs[name] = fn()
                        sync()
        breakdown = trace_breakdown(path, TRACE_CALLS)
    launches.update(_build.launches)
    after = untraced()
    for name, fn in plain.items():
        compare(kernel_of[name], outs[name], fn(),
                f"seventh path: traced {name} == its plain version")
    for name, s in breakdown.items():
        bare = (before[name] + after[name]) / 2
        log(f"trace {name}: wall {s['wall_us']:.1f} us per call (without "
            f"the profiler {before[name]:.1f} us before, {after[name]:.1f} "
            f"after), device busy {s['busy_us']:.1f} us, "
            f"idle share {s['idle']:.3f} (busy over the wall without the "
            f"profiler: {1 - s['busy_us'] / bare:.3f}), "
            f"{s['launches_per_call']:.1f} kernel "
            f"launches per call; most host self time per call: "
            + "; ".join(f"{k[:60]} {v:.1f} us" for k, v in s["top"]))
    log(f"seventh path: {time.perf_counter() - t_path:.1f} s")
    return dict(launches)


def main() -> int:
    import numpy as np
    import torch

    # -- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; nothing measured",
              file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    log(card)
    sm_mhz = float(nvidia_smi("clocks.max.sm").splitlines()[0].split()[0])
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"max SM clock {sm_mhz} MHz")

    import hexl_tpu_torch as port
    from hexl_tpu_torch import (NTT, _build, eltwise_mult_mod, nt,
                                poly_mult_mod, rns_poly_mult_mod)
    from hexl_tpu_torch.eltwise import ops, torch_kernels, torch_kernels32
    from hexl_tpu_torch.limb import to_numpy, to_tensor
    from hexl_tpu_torch.ntt import (cuda_ntt, get_plan, hier, ntt32, rns,
                                    torch_ntt)
    from hexl_tpu_torch import poly
    dyadic = importlib.import_module("hexl_tpu_torch.experimental.dyadic")
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    from hexl_tpu_torch import FFTLike
    from hexl_tpu_torch.experimental import cuda_fft, df32
    from hexl_tpu_torch.ntt import (fwd_ntt_mxu, get_mxu_plan, inv_ntt_mxu,
                                    mxu_ntt)
    from hexl_tpu_torch.ntt import shard
    from hexl_tpu_torch.parallel import mesh as pmesh
    from hexl_tpu_torch.parallel import pipeline
    from hexl_tpu_torch import config as port_config
    from hexl_tpu_torch.ntt import chain
    from hexl_tpu_torch.experimental import df_chain

    dev = torch.device("cuda", 0)
    sms = cuda_ntt.sm_count(dev)
    rng = np.random.default_rng(SEED)

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    def route(n, batch):
        return "K2" if cuda_ntt.polys_per_cta(n, batch) > 1 else "K1"

    # -- 2. build -----------------------------------------------------------
    probes = start_sass_probes(_build.nvcc_path(),
                               _build.BUILD_ROOT / "sass_probes")
    empty = start_empty_probe(_build.nvcc_path(),
                              _build.BUILD_ROOT / "sass_probes")
    info = _build.build_all()
    log(f"build: {info['seconds']:.1f} s (built={info['built']}) "
        f"in {info['dir']}")
    log(info["log"])
    imads = sass_imads(*probes)
    launch_empty = empty_probe(*empty)
    log(f"IMADs per product (SASS): {imads}")
    resources = _build.kernel_resources(info["log"])
    new = {k: v for k, v in resources.items() if NEW_INSTANTIATION.search(k)}
    log(f"build: {len(new)} lean, approx, chain, radix-walk, K2, K3, K5 "
        f"tiled, K16, eltwise, K10 and K9/K11 approx instantiations "
        f"(registers, stack, spill stores, spill loads): {new}")
    spilled = {k: v for k, v in new.items() if v[2] or v[3] or v[2] is None}
    if spilled or len(new) < NEW_INSTANTIATIONS:
        raise AssertionError(f"of {NEW_INSTANTIATIONS} new instantiations "
                             f"{len(new)} reported, spills: {spilled}")
    stacked = {k: v for k, v in resources.items()
               if RNS_INSTANTIATION.search(k)}
    log(f"build: {len(stacked)} stacked (RNS) instantiations (registers, "
        f"stack, spill stores, spill loads): {stacked}")
    spilled = {k: v for k, v in stacked.items()
               if v[2] or v[3] or v[2] is None}
    if spilled or len(stacked) < RNS_INSTANTIATIONS:
        raise AssertionError(f"of {RNS_INSTANTIATIONS} stacked "
                             f"instantiations {len(stacked)} reported, "
                             f"spills: {spilled}")
    clustered = {k: v for k, v in resources.items()
                 if CLUSTER_INSTANTIATION.search(k)}
    log(f"build: {len(clustered)} cluster-form instantiations (K1.rns.cl, "
        f"K6.rns.cl, K6.shard.cl; registers, stack, spill stores, spill "
        f"loads): {clustered}")
    spilled = {k: v for k, v in clustered.items()
               if v[2] or v[3] or v[2] is None}
    if spilled or len(clustered) != CLUSTER_INSTANTIATIONS:
        raise AssertionError(f"of {CLUSTER_INSTANTIATIONS} cluster-form "
                             f"instantiations {len(clustered)} reported, "
                             f"spills: {spilled}")
    log("cluster form, most active clusters: " + ", ".join(
        f"N=2^{ln} C={c} {rns.max_active_clusters(ln, c, dev)}"
        for ln in (12, 13, 14) for c in CLUSTER_SIZES))
    # K3's cluster form: how many clusters of two CTAs the card holds at
    # once (cudaOccupancyMaxActiveClusters), per degree.
    log("K3 cluster form, most active clusters: " + ", ".join(
        f"N=2^{k} {poly.max_active_clusters(1 << k, dev)}"
        for k in range(12, 15)))

    # -- 3. each kernel against its plain version, bit-exact ----------------
    max_err = {}

    def compare(kernel, got, want, what):
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item()) if got.numel() else 0
        max_err[kernel] = max(max_err.get(kernel, 0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at {what}")

    def compare_fft(kernel, got, want, precision, what):
        torch.cuda.synchronize()
        gp = cuda_fft.planes(got, precision)
        wp = cuda_fft.planes(want, precision)
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(gp, wp))
        max_err[kernel] = max(max_err.get(kernel, 0), err)
        if not all(torch.equal(a, b) for a, b in zip(gp, wp)):
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at {what}")

    t0 = time.perf_counter()
    checks = 0
    # Batches 1, 3 and 32 run one polynomial per CTA (K1, the radix walk,
    # at every degree: R = 2 below 16, then every split of the passes);
    # 401 packs P > 1 per CTA wherever N <= 2^12 (K2), with a ragged last
    # CTA.
    for log_n in range(1, 15):
        n = 1 << log_n
        for q_bits in (30, 50, 60, 61):
            q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
            plan = get_plan(n, q)
            for batch in ((1, 3, 32, 401) if n in (2, 16, 1024, 4096, 16384)
                          else (1, 3)):
                kernel = route(n, batch)
                for imf in (1, 2, 4):
                    x = rand((batch, n), imf * q)
                    for omf in (1, 4):
                        got = cuda_ntt.fwd_ntt(x, plan, imf, omf)
                        compare(kernel, got,
                                torch_ntt.fwd_ntt(x, plan, imf, omf),
                                f"fwd n={n} q_bits={q_bits} batch={batch} "
                                f"imf={imf} omf={omf}")
                        checks += 1
                for imf in (1, 2):
                    x = rand((batch, n), imf * q)
                    for omf in (1, 2):
                        got = cuda_ntt.inv_ntt(x, plan, imf, omf)
                        compare(kernel, got,
                                torch_ntt.inv_ntt(x, plan, imf, omf),
                                f"inv n={n} q_bits={q_bits} batch={batch} "
                                f"imf={imf} omf={omf}")
                        checks += 1
    # K3 at every N from 2 to 2^14, at batches 1, 2, 64 and 133, in every
    # form the wrapper takes at that degree (form_for's pick forced).
    for log_n in range(1, 15):
        n = 1 << log_n
        q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
        plan = get_plan(n, q)
        for batch in (1, 2, 64, 133):
            a, b = rand((batch, n), q), rand((batch, n), q)
            want = poly.poly_mult_plain(a, b, plan)
            for form in poly.forms_of(n):
                with forced_form(poly, form):
                    got = poly.poly_mult(a, b, plan)
                compare(poly.FORMS[form], got, want,
                        f"poly_mult n={n} batch={batch} form={form}")
                checks += 1
    # K2 at every N from 2 to 2^12 and every P its rule gives, and at every
    # power-of-two P its kernel takes.
    checks += packed_kernel_checks(rng, dev, nt, get_plan, cuda_ntt, hier,
                                   torch_ntt, to_tensor, compare)
    for q_bits in (30, 50, 60, 61):
        q = nt.generate_primes(1, q_bits, True, ntt_size=1 << 10)[0]
        for imf in (1, 2, 4):
            a, b = rand((1 << 20,), imf * q), rand((1 << 20,), imf * q)
            compare("K4", ops.mult_mod(a, b, q, imf),
                    torch_kernels.mult_mod(a, b, q, imf),
                    f"mult_mod q_bits={q_bits} imf={imf}")
            checks += 1
    # K5 and K6, each on inputs of its pass's range, at every count of
    # shards (2^log_d, log_d = 1 .. 6); batch 3 (or 2 at 2^20) is ragged
    # against nothing but exercises several polynomials.
    for n in (1 << 15, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20):
        for q_bits in (29, 50, 60, 61, 62):
            # generate_primes gives q in (2^b, 2^(b+1)); "62" is the
            # largest prime below 2^62 instead.
            q = (nt.generate_primes(1, 61, False, ntt_size=n)[0]
                 if q_bits == 62 else
                 nt.generate_primes(1, q_bits, True, ntt_size=n)[0])
            plan = get_plan(n, q)
            for batch in ((1, 2) if n == 1 << 20 else (1, 3)):
                blocks = (batch, n // hier.LOCAL_N, hier.LOCAL_N)
                for word in ((64, 32) if q_bits < 30 else (64,)):
                    k5 = k5_name(hier, n, batch, word)
                    k6 = hier.kernel_name("K6", word)
                    what = f"n={n} q_bits={q_bits} batch={batch} word={word}"
                    for imf in (1, 2, 4):
                        x = rand(blocks, imf * q)
                        c = hier.cross(x, plan, True, 1, word)
                        compare(k5, c, hier.cross_fwd_plain(x, plan, word),
                                f"cross fwd {what} imf={imf}")
                        c = c.view(batch, n)
                        for omf in (1, 4):
                            compare(k6, hier.local(c, plan, True, omf, word),
                                    hier.local_fwd_plain(c, plan, omf, word),
                                    f"local fwd {what} imf={imf} omf={omf}")
                        checks += 3
                    for imf in (1, 2):
                        x = rand((batch, n), imf * q)
                        loc = hier.local(x, plan, False, 1, word)
                        compare(k6, loc, hier.local_inv_plain(x, plan, word),
                                f"local inv {what} imf={imf}")
                        loc = loc.view(blocks)
                        for omf in (1, 2):
                            compare(k5, hier.cross(loc, plan, False, omf,
                                                   word),
                                    hier.cross_inv_plain(loc, plan, omf, word),
                                    f"cross inv {what} imf={imf} omf={omf}")
                        checks += 3
    # K7, the single-word NTT on the radix walk, against the plain
    # single-word walk at every N from 2 to 2^15 (batch 256 too at the
    # main paths' 2^10, 2^14 and 2^15, and at 2^13: more CTAs than SMs
    # take the 512-thread form at 2^13 and 2^14).
    for log_n in range(1, 16):
        n = 1 << log_n
        for q_bits in (20, 29):
            q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
            plan = get_plan(n, q)
            for batch in ((1, 3, 256) if log_n in (10, 13, 14, 15)
                          else (1, 3)):
                for imf in (1, 2, 4):
                    x = rand((batch, n), imf * q)
                    for omf in (1, 4):
                        compare("K7", cuda_ntt.fwd_ntt(x, plan, imf, omf, 32),
                                ntt32.fwd_ntt32(x, plan, imf, omf),
                                f"K7 fwd n={n} q_bits={q_bits} batch={batch} "
                                f"imf={imf} omf={omf}")
                        checks += 1
                for imf in (1, 2):
                    x = rand((batch, n), imf * q)
                    for omf in (1, 2):
                        compare("K7", cuda_ntt.inv_ntt(x, plan, imf, omf, 32),
                                ntt32.inv_ntt32(x, plan, imf, omf),
                                f"K7 inv n={n} q_bits={q_bits} batch={batch} "
                                f"imf={imf} omf={omf}")
                        checks += 1
    # K4 and K8, every op x word x IMF/OMF (cmp: every predicate, inputs
    # and bounds on both sides of 2^63), on a ragged 2^16 + 1 elements.
    for q_bits in (20, 29, 49, 60, 61, 62):
        q = top_modulus(nt, q_bits)
        for what, kernel, got, want in eltwise_cases(
                q, 65537, rng, dev, ops, torch_kernels, torch_kernels32, nt,
                to_tensor):
            compare(kernel, got, want, f"{what} q_bits={q_bits}")
            checks += 1
    # The streaming kernels' edges: odd counts, 2^22 + 3 elements, inputs
    # and outputs 8 bytes off a 16-byte boundary, empty tensors (K4/K8 and
    # their approximate forms, the row ops, K10 at every kc).
    checks += edge_kernel_checks(rng, dev, nt, _build, ops, ks, torch_kernels,
                                 torch_kernels32, to_tensor, port_config,
                                 compare)
    # K9 over moduli of mixed bit lengths, alone and with 4 weights.
    dy_moduli = [top_modulus(nt, b) for b in (20, 40, 50, 60, 62)]
    for weights in (1, 4):
        x, y = (torch.stack([torch.stack([torch.stack([
            rand((16387,), q) for q in dy_moduli]) for _ in range(2)])
            for _ in range(weights)]) for _ in range(2))
        compare("K9", dyadic.dyadic(x, y, dy_moduli),
                dyadic.dyadic_plain(x, y, dyadic.row_constants(
                    tuple(dy_moduli), dev)), f"dyadic weights={weights}")
        checks += 1
    # K10 and K11 against their plain versions: a basis of mixed bit
    # lengths up to 61 bits at 2^14, and the main path's 2^15 x ds 14.
    for n, bits, kc in ((1 << 14, (61, 50, 60, 45), 3),
                        (1 << 15, (49,) * 15, 2)):
        ds = len(bits) - 1
        result, t, keys, moduli, msf = key_switch_inputs(rng, n, bits, kc,
                                                         dev, nt, to_tensor)
        c = ks.constants(tuple(moduli), tuple(msf), ds, dev)
        tq = torch.stack([rand((ds, n), 4 * q) for q in moduli])
        what = f"n={n} ds={ds} kc={kc}"
        tpp = ks.mac_flush_parts(*block_parts(tq, ds), keys, c, ds, kc,
                                 ds + 1)
        compare("K10", tpp, ks.mac_flush_plain(tq, keys, c.mac, ds, kc,
                                              ds + 1),
                f"mac_flush_parts {what}")
        x = rand((kc, n), 2 * moduli[-1])
        compare("K11", ks.spread(x, c), ks.spread_plain(x, c),
                f"spread {what}")
        tntt = torch.stack([rand((kc, n), 4 * q) for q in moduli[:ds]])
        compare("K11", ks.fold(result, tpp, tntt, c),
                ks.fold_plain(result, tpp, tntt, c), f"fold {what}")
        checks += 3
    # K12 and K13 in every precision, bit-exact: their float arithmetic is
    # never contracted into FMAs, and the plain walks are separate torch
    # ops; max_abs_err is over every plane.
    for kernel, precision, what, got, want in fft_kernel_cases(
            rng, dev, FFTLike, cuda_fft):
        compare_fft(kernel, got, want, precision, what)
        checks += 1
    # K14 and K15 on the int32 planes of every pass of the four-step NTT.
    checks += mxu_kernel_checks(rng, dev, nt, get_mxu_plan, mxu_ntt,
                                to_tensor, compare)
    # K5 with a column stride, K6 with a shard base and K16: the kernels of
    # the parallel layer.
    checks += parallel_kernel_checks(rng, dev, nt, get_plan, hier, shard,
                                     pipeline, to_tensor, compare)
    # K5 in each form at every D, word and scheme, the two-launch form and
    # a position's intra-shard stages.
    checks += tile_kernel_checks(rng, dev, nt, get_plan, hier, shard,
                                 torch_ntt, to_tensor, compare)
    # The lean instantiations of K1/K2/K5/K6, and the chains K17 and K18.
    checks += lean_kernel_checks(rng, dev, nt, get_plan, cuda_ntt, hier,
                                 torch_ntt, to_tensor, compare, route)
    # The approx instantiations (the Pallas kernels' butterflies) of K1, K2,
    # K3, K5, K6 and K16, and the eltwise family's approximate quotients.
    checks += approx_kernel_checks(rng, dev, nt, get_plan, cuda_ntt, hier,
                                   shard, poly, pipeline, ops, torch_kernels,
                                   torch_ntt, to_tensor, port_config,
                                   compare, route)
    # The composites' approximate quotients (K9, K10, K11) and K3 in the
    # lean schemes.
    checks += composite_approx_checks(rng, dev, nt, get_plan, poly, dyadic,
                                      ks, to_tensor, port_config, compare)
    checks += chain_kernel_checks(rng, dev, chain, df_chain, compare,
                                  compare_fft)
    # The stacked transform's kernels (K1.rns, K2.rns, K5.rns in both forms,
    # K6.rns) and the row ops (K4.rows, K8.reduce.rows).
    checks += rns_kernel_checks(rng, dev, nt, rns, hier, ops, torch_kernels,
                                torch_ntt, to_tensor, compare)
    # The cluster form (K1.rns.cl, K6.rns.cl) at every C and degree the
    # rule can pick, and the routed one-prime calls.
    checks += cluster_kernel_checks(rng, dev, nt, rns, cuda_ntt, get_plan,
                                    torch_ntt, to_tensor, compare,
                                    _build.launches)
    # K6.shard.cl, a DistNTT position's local pass on a cluster.
    checks += shard_cluster_checks(rng, dev, nt, get_plan, rns, shard,
                                   to_tensor, compare, _build.launches)
    log(f"phase 3: {checks} kernel-vs-plain checks bit-exact in "
        f"{time.perf_counter() - t0:.1f} s; max_abs_err {max_err}")

    # -- 4. the main paths through the public entry points ------------------
    # The first: bench.py's transform pair (2^14, 60-bit, batch 256); the
    # __graft_entry__ pipeline (2^12, 50-bit, batch 2); the repo's 29-bit
    # Xeon row, NTT(2^10), at a batch that fills the card (a q < 2^30 there
    # takes the single-word K7, as in the JAX engine), and the same
    # transform at 49 bits (one polynomial per CTA, K1); NTT(2^6, 49-bit) at
    # batch 8192 (the packed route K2, a CTA of one warp holding four
    # polynomials); poly_mult_mod at (2^12, 50-bit, 2) and (2^14, 60-bit,
    # 64) (K3's cluster form) and at (2^13, 60-bit, 132) (its one-CTA form:
    # 2 x 132 CTAs would outnumber the SMs); RnsNTT at (2^14, 16 primes of
    # 50 bits, batch 16), one launch a direction for the basis (K1.rns), and
    # at (2^6, 3 primes of 49 bits, batch 4096) (K2.rns).
    n14, n12, n10 = 1 << 14, 1 << 12, 1 << 10
    q60 = nt.generate_primes(1, 60, True, ntt_size=n14)[0]
    q50 = nt.generate_primes(1, 50, True, ntt_size=n12)[0]
    q49 = nt.generate_primes(1, 49, True, ntt_size=n10)[0]
    q29 = nt.generate_primes(1, 29, True, ntt_size=n10)[0]
    q49_6 = nt.generate_primes(1, 49, True, ntt_size=PACKED_N)[0]
    x14 = rng.integers(0, q60, size=(256, n14), dtype=np.uint64)
    a12, b12 = (rng.integers(0, q50, size=(2, n12), dtype=np.uint64)
                for _ in range(2))
    x10 = rng.integers(0, q49, size=(N10_BATCH, n10), dtype=np.uint64)
    x10s = rng.integers(0, q29, size=(N10_BATCH, n10), dtype=np.uint64)
    x6 = rng.integers(0, q49_6, size=(PACKED_BATCH, PACKED_N),
                      dtype=np.uint64)
    a14, b14 = (rng.integers(0, q60, size=(64, n14), dtype=np.uint64)
                for _ in range(2))
    a13, b13 = (rng.integers(0, q60, size=(CTA_BATCH, CTA_N),
                             dtype=np.uint64) for _ in range(2))
    ta12, tb12 = to_tensor(a12, dev), to_tensor(b12, dev)
    ntt14, ntt12, ntt10 = NTT(n14, q60), NTT(n12, q50), NTT(n10, q49)
    ntt10s = NTT(n10, q29)
    ntt6 = NTT(PACKED_N, q49_6)
    rns14 = port.RnsNTT(n14, nt.generate_primes(RNS_PRIMES, 50, True,
                                                ntt_size=n14))
    rns6 = port.RnsNTT(PACKED_N, nt.generate_primes(3, 49, True,
                                                    ntt_size=PACKED_N))
    xr14 = torch.stack([rand((SPLIT_BATCH, n14), q) for q in rns14.moduli])
    xr6 = torch.stack([rand((PACKED_BATCH // 2, PACKED_N), q)
                       for q in rns6.moduli])
    torch.cuda.synchronize()

    _build.reset_launches()
    y14 = ntt14.forward(x14)
    back14 = ntt14.inverse(y14)
    fa = ntt12.forward(ta12, 1, 4)
    fb = ntt12.forward(tb12, 1, 4)
    prod = eltwise_mult_mod(fa, fb, q50, 4)
    step = ntt12.inverse(prod, 1, 1)
    y10s = ntt10s.forward(x10s)
    back10s = ntt10s.inverse(y10s)
    y10 = ntt10.forward(x10)
    back10 = ntt10.inverse(y10)
    y6 = ntt6.forward(x6)
    back6 = ntt6.inverse(y6)
    c12 = poly_mult_mod(a12, b12, n12, q50)
    c14 = poly_mult_mod(a14, b14, n14, q60)
    c13 = poly_mult_mod(a13, b13, CTA_N, q60)
    yr14 = rns14.forward(xr14)
    backr14 = rns14.inverse(yr14)
    yr6 = rns6.forward(xr6)
    backr6 = rns6.inverse(yr6)
    torch.cuda.synchronize()
    launches1 = dict(_build.launches)
    log(f"phase 4: first main path's launches {launches1}; routes: "
        f"(2^14, 256) {route(n14, 256)}, (2^12, 2) {route(n12, 2)}, "
        f"(2^10, {N10_BATCH}) {route(n10, N10_BATCH)}, (2^6, {PACKED_BATCH}) "
        f"{route(PACKED_N, PACKED_BATCH)} with "
        f"P={cuda_ntt.polys_per_cta(PACKED_N, PACKED_BATCH)}; K3 forms on "
        f"{sms} SMs: (2^12, 2) {poly.form_for(n12, 2, sms)}, (2^13, "
        f"{CTA_BATCH}) {poly.form_for(CTA_N, CTA_BATCH, sms)}, (2^14, 64) "
        f"{poly.form_for(n14, 64, sms)}")
    missing = [k for k in ("K1", "K2", "K3", "K3.cta", "K4", "K7")
               if launches1.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"first main path launched no {missing}")
    if (launches1.get("K1.rns"), launches1.get("K2.rns")) != (2, 2):
        raise AssertionError(f"first main path's RnsNTT pairs launched "
                             f"{launches1}, not one launch a direction")

    # Every main-path output against the plain version on the same inputs.
    plan14, plan12, plan10 = (get_plan(n14, q60), get_plan(n12, q50),
                              get_plan(n10, q49))
    plan10s = get_plan(n10, q29)
    plan6 = get_plan(PACKED_N, q49_6)
    t = lambda v: to_tensor(v, dev)
    compare(route(n14, 256), t(y14), torch_ntt.fwd_ntt(t(x14), plan14),
            "main path: NTT(2^14, 60-bit).forward, batch 256")
    compare(route(n14, 256), t(back14), torch_ntt.inv_ntt(t(y14), plan14),
            "main path: NTT(2^14, 60-bit).inverse, batch 256")
    compare(route(n12, 2), fa, torch_ntt.fwd_ntt(ta12, plan12, 1, 4),
            "main path: pipeline fwd(a) OMF 4")
    compare(route(n12, 2), fb, torch_ntt.fwd_ntt(tb12, plan12, 1, 4),
            "main path: pipeline fwd(b) OMF 4")
    compare("K4", prod, torch_kernels.mult_mod(fa, fb, q50, 4),
            "main path: pipeline mult_mod IMF 4")
    compare(route(n12, 2), step, torch_ntt.inv_ntt(prod, plan12),
            "main path: pipeline inverse")
    compare("K7", t(y10s), ntt32.fwd_ntt32(t(x10s), plan10s),
            f"main path: NTT(2^10, 29-bit).forward, batch {N10_BATCH}")
    compare("K7", t(back10s), ntt32.inv_ntt32(t(y10s), plan10s),
            f"main path: NTT(2^10, 29-bit).inverse, batch {N10_BATCH}")
    compare(route(n10, N10_BATCH), t(y10), torch_ntt.fwd_ntt(t(x10), plan10),
            f"main path: NTT(2^10, 49-bit).forward, batch {N10_BATCH}")
    compare(route(n10, N10_BATCH), t(back10),
            torch_ntt.inv_ntt(t(y10), plan10),
            f"main path: NTT(2^10, 49-bit).inverse, batch {N10_BATCH}")
    compare(route(PACKED_N, PACKED_BATCH), t(y6),
            torch_ntt.fwd_ntt(t(x6), plan6),
            f"main path: NTT(2^6, 49-bit).forward, batch {PACKED_BATCH}")
    compare(route(PACKED_N, PACKED_BATCH), t(back6),
            torch_ntt.inv_ntt(t(y6), plan6),
            f"main path: NTT(2^6, 49-bit).inverse, batch {PACKED_BATCH}")
    plan13 = get_plan(CTA_N, q60)
    for c, a, b, plan in ((c12, a12, b12, plan12), (c14, a14, b14, plan14),
                          (c13, a13, b13, plan13)):
        compare(poly.FORMS[poly.form_for(plan.n, a.shape[0], sms)], t(c),
                poly.poly_mult_plain(t(a), t(b), plan),
                f"main path: poly_mult_mod n={plan.n}")
    if not (np.array_equal(back14, x14) and np.array_equal(back10, x10)
            and np.array_equal(back10s, x10s)
            and np.array_equal(back6, x6)):
        raise AssertionError("NTT round trip failed")
    for name, e, x, y, back in (("K1.rns", rns14, xr14, yr14, backr14),
                                ("K2.rns", rns6, xr6, yr6, backr6)):
        what = f"main path: RnsNTT(2^{e.degree.bit_length() - 1}, " \
               f"{len(e.moduli)} primes)"
        compare(name, y, rns.fwd_ntt_rns_plain(x, e.plan), f"{what}.forward")
        compare(name, back, rns.inv_ntt_rns_plain(y, e.plan),
                f"{what}.inverse")
        if not torch.equal(back, x):
            raise AssertionError(f"{what} round trip failed")
    if not np.array_equal(to_numpy(step), c12):
        raise AssertionError("__graft_entry__ pipeline != poly_mult_mod")
    # A schoolbook negacyclic product in Python integers, after the counts
    # were read: this call is a check, not part of the main path.
    q64 = nt.generate_primes(1, 60, True, ntt_size=64)[0]
    a64, b64 = (rng.integers(0, q64, size=(2, 64), dtype=np.uint64)
                for _ in range(2))
    c64 = poly_mult_mod(a64, b64, 64, q64)
    for row in range(2):
        ai, bi = [int(v) for v in a64[row]], [int(v) for v in b64[row]]
        school = [0] * 64
        for i in range(64):
            for j in range(64):
                k, s = (i + j, 1) if i + j < 64 else (i + j - 64, -1)
                school[k] += s * ai[i] * bi[j]
        if [int(v) for v in c64[row]] != [v % q64 for v in school]:
            raise AssertionError("poly_mult_mod n=64 != schoolbook product")
    log("phase 4: every output of the first main path == its plain version; "
        "round trips exact; pipeline == poly_mult_mod; n=64 == schoolbook")

    # The second: N above 2^14 and the single-word regime. NTT(2^17) at
    # 60 and 29 bits (the Xeon rows' degree) at batch 16; NTT(2^14, 29-bit)
    # at batch 256 (K7); NTT(2^20, 60-bit), the largest degree, at batch 2;
    # and BASELINE.json's RNS poly-mult, N=2^17 x 16 primes of 50 bits
    # (stacked: K5.rns, K6.rns, K4.rows); RnsNTT(2^20, 3 primes of 60 bits)
    # at batch 1 (K5.rns's tiled form at D = 64, K6.rns).
    n17, n20 = 1 << 17, 1 << 20
    q60_17 = nt.generate_primes(1, 60, True, ntt_size=n17)[0]
    q29_17 = nt.generate_primes(1, 29, True, ntt_size=n17)[0]
    q29_14 = nt.generate_primes(1, 29, True, ntt_size=n14)[0]
    q60_20 = nt.generate_primes(1, 60, True, ntt_size=n20)[0]
    moduli = nt.generate_primes(RNS_PRIMES, 50, True, ntt_size=n17)
    x17 = rand((SPLIT_BATCH, n17), q60_17)
    x17s = rand((SPLIT_BATCH, n17), q29_17)
    x14s = rand((256, n14), q29_14)
    x20 = rand((2, n20), q60_20)
    ra = torch.stack([rand((n17,), q) for q in moduli])
    rb = torch.stack([rand((n17,), q) for q in moduli])
    e17, e17s = NTT(n17, q60_17), NTT(n17, q29_17)
    e14s, e20 = NTT(n14, q29_14), NTT(n20, q60_20)
    rns_plans = [get_plan(n17, q) for q in moduli]
    rns20 = port.RnsNTT(n20, nt.generate_primes(3, 60, True, ntt_size=n20))
    xr20 = torch.stack([rand((n20,), q) for q in rns20.moduli])
    torch.cuda.synchronize()

    _build.reset_launches()
    y17 = e17.forward(x17)
    back17 = e17.inverse(y17)
    y17s = e17s.forward(x17s)
    back17s = e17s.inverse(y17s)
    y14s = e14s.forward(x14s)
    back14s = e14s.inverse(y14s)
    y20 = e20.forward(x20)
    back20 = e20.inverse(y20)
    rc = rns_poly_mult_mod(ra, rb, n17, moduli)
    yr20 = rns20.forward(xr20)
    backr20 = rns20.inverse(yr20)
    torch.cuda.synchronize()
    launches2 = dict(_build.launches)
    log(f"phase 4: second main path's launches {launches2}")
    # Every call launched its kernels, and nothing else ran: two passes per
    # transform (K5 in its tiled form at 2^20), 7 launches for the whole
    # basis of the RNS product (three stacked transforms of two passes and
    # K4.rows), two passes for each stacked transform of RnsNTT(2^20).
    # The local passes' kernels are the cluster rule's (K6, K6.rns or
    # K6.rns.cl, `transform_launches`).
    def local_name(n, rows, batch, stacked):
        return next(k for k in transform_launches(rns, sms, dev, n, rows,
                                                  batch, stacked)
                    if k.startswith("K6"))
    expected = collections.Counter({
        "K5": 2, "K5.tile": 2, "K5.u32": 2, "K6.u32": 2, "K7": 2,
        "K5.rns": 3, "K4.rows": 1, "K5.tile.rns": 2})
    for n, rows, batch, stacked, count in (
            (n17, 1, SPLIT_BATCH, False, 2), (n20, 1, 2, False, 2),
            (n17, RNS_PRIMES, 1, True, 3), (n20, 3, 1, True, 2)):
        expected[local_name(n, rows, batch, stacked)] += count
    expected = dict(expected)
    if launches2 != expected:
        raise AssertionError(f"second main path launched {launches2}, "
                             f"expected {expected}")

    # Every output against the plain flat walk (64-bit or single-word) on
    # the same inputs; a forward output is K6's, an inverse output K5's.
    for name, e, x, y, back, word in (
            ("NTT(2^17, 60-bit)", e17, x17, y17, back17, 64),
            ("NTT(2^17, 29-bit)", e17s, x17s, y17s, back17s, 32),
            ("NTT(2^20, 60-bit)", e20, x20, y20, back20, 64)):
        compare(hier.kernel_name("K6", word), y,
                torch_ntt.fwd_ntt(x, e.plan, word=word),
                f"main path: {name}.forward")
        compare(k5_name(hier, e.plan.n, x.shape[0], word), back,
                torch_ntt.inv_ntt(y, e.plan, word=word),
                f"main path: {name}.inverse")
        if not torch.equal(back, x):
            raise AssertionError(f"{name} round trip failed")
    compare("K7", y14s, ntt32.fwd_ntt32(x14s, e14s.plan),
            "main path: NTT(2^14, 29-bit).forward, batch 256")
    compare("K7", back14s, ntt32.inv_ntt32(y14s, e14s.plan),
            "main path: NTT(2^14, 29-bit).inverse, batch 256")
    if not torch.equal(back14s, x14s):
        raise AssertionError("NTT(2^14, 29-bit) round trip failed")
    for i, plan in enumerate(rns_plans):
        compare("K5.rns", rc[i], poly.poly_mult_plain(ra[i], rb[i], plan),
                f"main path: rns_poly_mult_mod prime {i}")
    compare("K6.rns", yr20, rns.fwd_ntt_rns_plain(xr20, rns20.plan),
            "main path: RnsNTT(2^20, 3 primes).forward")
    compare("K5.tile.rns", backr20, rns.inv_ntt_rns_plain(yr20, rns20.plan),
            "main path: RnsNTT(2^20, 3 primes).inverse")
    if not torch.equal(backr20, xr20):
        raise AssertionError("RnsNTT(2^20) round trip failed")
    oracle = negacyclic_product(to_numpy(ra[0]), to_numpy(rb[0]), moduli[0])
    if not np.array_equal(to_numpy(rc[0]), oracle):
        raise AssertionError("rns_poly_mult_mod prime 0 != the NumPy product")
    log("phase 4: every output of the second main path == its plain version; "
        "round trips exact; RNS prime 0 == the NumPy FFT product")

    # The third: the eltwise family and the SEAL-shim composites through
    # the public entry points. Each eltwise op at its Xeon row's shape
    # (add/sub 2^12, 60-bit; mult_mod and reduce_mod 2^13 at 49 and 60
    # bits; fma, cmp_add, cmp_sub_mod and reduce 2->1 at 2^14, 59-bit, and
    # fma/cmp over BASELINE.json's 8 primes; Montgomery 2^13 on the Xeon
    # row's 47-bit modulus), then every op at 2^22 elements (a 2-polynomial
    # ciphertext over 16 primes at N=2^17: 60-bit q, and 29-bit for the
    # single-word bodies); dyadic_multiply at the Xeon row (2^14 x 4 primes
    # of 50 bits) and at BASELINE.json's basis (2^17 x 16 primes of 50
    # bits); lr_mat_vec_mult at 2^14 x 4 primes x 16 weights; key_switch
    # at the three Xeon shapes and at N=2^15 x ds 14 (49-bit, kc 2).
    third = third_path(rng, dev, port, nt, torch_kernels, torch_kernels32,
                       dyadic, ks, to_tensor, moduli)
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = [call() for _, _, call, _ in third]
    torch.cuda.synchronize()
    launches3 = dict(_build.launches)
    log(f"phase 4: third main path's launches {launches3}")
    ks_kernels = {k for n_ks, ds_ks in KS_SHAPES
                  for k in key_switch_launches(rns, sms, dev, n_ks, ds_ks)}
    missing = [k for k in sorted(set(THIRD_PATH_KERNELS) | ks_kernels)
               if launches3.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"third main path launched no {missing}")
    for (what, kernel, _, plain), out in zip(third, outs):
        compare(kernel, out, plain(), f"main path: {what}")
    # Each key switch on its own: its transforms stacked over the ds
    # decomposition primes (three stacked transforms, K8.reduce.rows), the
    # key prime's forward and inverse, K10, K11 twice.
    for what, _, call, _ in third:
        if not what.startswith("key_switch"):
            continue
        n_ks = int(what.split("N=2^")[1].split()[0])
        ds_ks = int(what.split("ds=")[1])
        want = key_switch_launches(rns, sms, dev, 1 << n_ks, ds_ks)
        _build.reset_launches()
        call()
        if dict(_build.launches) != want:
            raise AssertionError(f"main path: {what} launched "
                                 f"{dict(_build.launches)}, expected {want}")
    # One small key switch against Python integers, after the counts.
    res, tt, kk, ks_moduli, msf = key_switch_inputs(rng, 64, (40, 41, 45), 2,
                                                    dev, nt, to_tensor)
    got = port.key_switch(res, tt, 64, 2, 3, 3, 2, ks_moduli, kk, msf)
    lists = lambda v: [[int(x) for x in row] for row in to_numpy(v)]
    want = key_switch_oracle(
        [lists(c) for c in res], lists(tt),
        [[lists(kk[j, k]) for k in range(2)] for j in range(2)], ks_moduli,
        msf, nt)
    if [lists(c) for c in got] != want:
        raise AssertionError("key_switch n=64 != the Python-integer oracle")
    log(f"phase 4: every output of the third main path ({len(third)} calls) "
        "== its plain version; key_switch n=64 == the Python-integer oracle")

    # The fourth: CKKS encode and decode through the public FFTLike at
    # n = 2^14 slots (N = 2^15), scale 2^40, batch 64, in "auto" (f64),
    # "single" and "double_float". Encode is the inverse; decode composes
    # the plaintext's 2-word integers mod Q (two 60-bit primes) with
    # build_floating_points_device and runs the forward. The encoded
    # coefficients are rounded at 2^20 times the scale, so the rounding
    # stays below the round trip's 1e-12. Then the Xeon rows' FFT shapes
    # (n = 2^12 and 2^14, one polynomial, a 2^-30 scale fused) and the
    # four-step NTT at bench.py's shape (2^14, 60-bit, batch 256) and at
    # N = 2^17 (60-bit, batch 16), on the first and second paths' inputs.
    slots = torch.from_numpy(rng.normal(size=(FFT_BATCH, FFT_N))
                             + 1j * rng.normal(size=(FFT_BATCH, FFT_N))).to(dev)
    engines = {p: FFTLike(FFT_N, FFT_SCALAR, precision=p)
               for p in ("auto", "single", "double_float")}
    q_dec = 1
    for p in nt.generate_primes(2, 60, True, ntt_size=2 * FFT_N):
        q_dec *= p
    q_words = [(q_dec >> (64 * w)) & ((1 << 64) - 1) for w in range(2)]
    thr_words = [((q_dec >> 1) >> (64 * w)) & ((1 << 64) - 1)
                 for w in range(2)]
    xeon_in = {n: torch.from_numpy(rng.uniform(-1, 1, (1, n))
                                   + 1j * rng.uniform(-1, 1, (1, n))).to(dev)
               for n in (n12, n14)}
    xeon_fft = {n: FFTLike(n, XEON_FFT_SCALAR) for n in xeon_in}
    mxu_cases = ((get_mxu_plan(n14, q60), t(x14), t(y14)),
                 (get_mxu_plan(n17, q60_17), x17, y17))
    torch.cuda.synchronize()

    _build.reset_launches()
    encoded, composed, decoded = {}, {}, {}
    for p, e in engines.items():
        encoded[p] = e.inverse(slots)
        df = e.build_floating_points_device(ckks_words(encoded[p], q_words),
                                            thr_words, q_words,
                                            2.0 ** -FIXED_POINT_BITS)
        re, im = (df32.DF(df.hi[i], df.lo[i]) for i in range(2))
        if p == "double_float":
            composed[p] = df32.CDF(re, im)
            decoded_df = e.df_fwd_body(composed[p], e.fused_scale(True))
            decoded[p] = df32.cdf_to_complex128(decoded_df)
        else:
            composed[p] = torch.complex(df32.df_to_f64(re),
                                        df32.df_to_f64(im))
            decoded[p] = e.forward(composed[p])
    xeon_out = {n: (xeon_fft[n].forward(x), xeon_fft[n].inverse(x))
                for n, x in xeon_in.items()}
    mxu_out = [(fwd_ntt_mxu(x, plan), inv_ntt_mxu(y, plan))
               for plan, x, y in mxu_cases]
    torch.cuda.synchronize()
    launches4 = dict(_build.launches)
    log(f"phase 4: fourth main path's launches {launches4}")
    # Encode and decode of three precisions (K13 + K12 each), the Xeon
    # shapes (K12 twice at 2^12, K13 + K12 twice at 2^14), and two
    # passes per MXU transform.
    expected = {"K12.f64": 6, "K13.f64": 4, "K12.f32": 2, "K13.f32": 2,
                "K12.df": 2, "K13.df": 2, "K14": 4, "K15": 4}
    if launches4 != expected:
        raise AssertionError(f"fourth main path launched {launches4}, "
                             f"expected {expected}")

    # Every output against the plain version on the same inputs.
    for p, e in engines.items():
        prec = e.precision
        fwd_t, inv_t = e.tables(dev)
        k12, k13 = (cuda_fft.kernel_name(k, prec) for k in ("K12", "K13"))
        if prec == "double_float":
            plain = df32.cdf_to_complex128(cuda_fft.walk_plain(
                df32.cdf_from_complex128(slots), inv_t, e.fused_scale(False),
                prec, False))
            compare_fft(k13, encoded[p], plain, "f64",
                        "main path: CKKS encode, double_float")
            want = cuda_fft.walk_plain(composed[p], fwd_t, e.fused_scale(True),
                                       prec, True)
            compare_fft(k12, decoded_df, want, prec,
                        "main path: CKKS decode, double_float")
        else:
            compare_fft(k13, encoded[p], cuda_fft.walk_plain(
                slots.to(encoded[p].dtype), inv_t, e.fused_scale(False), prec,
                False), prec, f"main path: CKKS encode, {p}")
            compare_fft(k12, decoded[p], cuda_fft.walk_plain(
                composed[p].to(decoded[p].dtype), fwd_t, e.fused_scale(True),
                prec, True), prec, f"main path: CKKS decode, {p}")
        rel = float((decoded[p] - slots).abs().max() / slots.abs().max())
        limit = 1e-4 if prec == "single" else 1e-12
        log(f"phase 4: CKKS round trip {p}: relative error {rel:.3e} "
            f"(limit {limit})")
        if not rel < limit:
            raise AssertionError(f"CKKS round trip {p}: {rel} >= {limit}")
    # The device compose against the host one (Python integers, float64).
    words = to_numpy(ckks_words(encoded["auto"], q_words)[:, 0, 0, :512])
    host = engines["auto"].build_floating_points(words, thr_words, q_words,
                                                 2.0 ** -FIXED_POINT_BITS)
    dev_re = composed["auto"].real[0, :512].cpu().numpy()
    if not np.allclose(dev_re, host.real, rtol=3e-14, atol=1e-20):
        raise AssertionError("build_floating_points_device != the host "
                             "compose")
    for n, x in xeon_in.items():
        e = xeon_fft[n]
        fwd_t, inv_t = e.tables(dev)
        compare_fft("K12.f64", xeon_out[n][0], cuda_fft.walk_plain(
            x, fwd_t, e.fused_scale(True), "f64", True), "f64",
            f"main path: FFTLike({n}).forward")
        compare_fft("K13.f64" if n > cuda_fft.BLOCK_N else "K12.f64",
                    xeon_out[n][1], cuda_fft.walk_plain(
                        x, inv_t, e.fused_scale(False), "f64", False), "f64",
                    f"main path: FFTLike({n}).inverse")
    for (plan, x, y), (fy, ix) in zip(mxu_cases, mxu_out):
        what = f"main path: MXU NTT(2^{plan.log_n}, 60-bit)"
        compare("K15", fy, mxu_ntt._passes(
            x, plan, True, 1, mxu_ntt.fold_twiddle_plain,
            mxu_ntt.fold_final_plain), f"{what}.forward")
        compare("K15", ix, mxu_ntt._passes(
            y, plan, False, 1, mxu_ntt.fold_twiddle_plain,
            mxu_ntt.fold_final_plain), f"{what}.inverse")
        if not (torch.equal(fy, y) and torch.equal(ix, x)):
            raise AssertionError(f"{what} != NTT on the same inputs")
    log("phase 4: every output of the fourth main path == its plain version; "
        "CKKS round trips within their limits; the device compose == the "
        "host one; the MXU NTT's outputs == NTT's (K1 at 2^14, K5/K6 at "
        "2^17)")

    # The fifth: the parallel layer on meshes of cuda:0 positions
    # (`fifth_path`).
    f5 = fifth_path(rng, dev, moduli)
    fifth, ra2, rb2, xd, xp = f5.calls, f5.ra2, f5.rb2, f5.xd, f5.xp
    ks_res, ks_t, ks_keys, ks5_moduli, ks_msf = f5.key_switch
    dy5 = f5.dy5
    torch.cuda.synchronize()

    _build.reset_launches()
    pmesh.reset_exchanges()
    outs5 = {name: call() for name, (call, _, _) in fifth.items()}
    torch.cuda.synchronize()
    launches5 = dict(_build.launches)
    exchanges5 = dict(pmesh.exchanges)
    log(f"phase 4: fifth main path's launches {launches5}; exchanges "
        f"{exchanges5}")
    missing = [k for k in ("K1", "K4", "K5", "K6", "K8.reduce", "K9", "K10",
                           "K11", "K16", shard.CLUSTER_NAME)
               if launches5.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"fifth main path launched no {missing}")

    # Every output against the port's single-device call and the plain path
    # on the same inputs (after the counts were read).
    ones = {name: single() for name, (_, _, single) in fifth.items()}
    for name, out in outs5.items():
        pairs = list(zip(out, ones[name])) if isinstance(out, tuple) \
            else [(out, ones[name])]
        for got, want in pairs:
            kernel = ("K16" if name.startswith("Pipeline") else
                      "K11" if "key_switch" in name else
                      "K9" if "dyadic" in name else "K6.shard")
            compare(kernel, got, want, f"main path: {name} == one device")
    ks_plain = ks.key_switch_plain(ks_res, ks_t, n14, 3, 4, 4, 2, ks5_moduli,
                                   ks_keys, ks_msf)
    dy_plain = dyadic.dyadic_plain(dy5[0][None], dy5[1][None],
                                   dyadic.row_constants(tuple(ks5_moduli),
                                                        dev))
    for name, out in outs5.items():
        if name.startswith("dist_rns"):
            for i, q in enumerate(moduli):
                compare("K6.shard", out[i], poly.poly_mult_plain(
                    ra2[i], rb2[i], get_plan(n17, q)),
                    f"main path: {name}, prime {i} == the plain path")
        elif name.startswith("DistNTT"):
            compare("K6.shard", out[0], torch_ntt.fwd_ntt(xd, plan14),
                    f"main path: {name}, forward == the plain walk")
            if not torch.equal(out[1], xd):
                raise AssertionError(f"{name}: round trip failed")
        elif name.startswith("Pipeline"):
            compare("K16", out[0], torch_ntt.fwd_ntt(xp, plan14),
                    f"main path: {name}, forward == the plain walk")
            if not torch.equal(out[1], xp):
                raise AssertionError(f"{name}: round trip failed")
        elif "key_switch" in name:
            compare("K11", out, ks_plain, f"main path: {name} == plain")
        else:
            compare("K9", out, dy_plain, f"main path: {name} == plain")
    log(f"phase 4: every output of the fifth main path ({len(fifth)} calls) "
        "== the port's single-device call and the plain path on the same "
        "inputs; round trips exact")

    # The sixth: the approximate-butterfly regime of the JAX engine's device
    # bodies, forced on (config.approx_butterflies, as the JAX tests force
    # theirs): bench.py's shape at 60 bits (lean8) and 59 bits (lean16),
    # NTT(2^17, 50-bit) at batch 16 (lean16 through K5/K6), NTT(2^10,
    # 49-bit) at batch 4096 (lean8 through K1) and NTT(2^6, 49-bit) at batch
    # 8192 (lean8 through K2), BASELINE.json's RNS product
    # at N=2^17 x 16 primes of 50 bits (lean16); and the two probes as their
    # benchmarks run them: K17's lean16 chain and its exact sibling on two
    # 16384 x 128 planes, K18 on 8192 x 128 in double-float, f64 and single.
    q59 = nt.generate_primes(1, 59, True, ntt_size=n14)[0]
    q50_17 = nt.generate_primes(1, 50, True, ntt_size=n17)[0]
    sixth = {
        "lean8": ("NTT(2^14, 60-bit), batch 256", ntt14,
                  rand((256, n14), q60)),
        "lean16": ("NTT(2^14, 59-bit), batch 256", NTT(n14, q59),
                   rand((256, n14), q59)),
        "lean16 split": ("NTT(2^17, 50-bit), batch 16", NTT(n17, q50_17),
                         rand((SPLIT_BATCH, n17), q50_17)),
        "lean8 n10": (f"NTT(2^10, 49-bit), batch {N10_BATCH}", ntt10,
                      rand((N10_BATCH, n10), q49)),
        "lean8 packed": (f"NTT(2^6, 49-bit), batch {PACKED_BATCH}", ntt6,
                         rand((PACKED_BATCH, PACKED_N), q49_6)),
    }
    cx, cy = chain.probe_inputs(rng, dev)
    # One set of complex values in every precision, so that the three K18
    # chains can be held against each other.
    zxy = [fft_value(rng, (df_chain.ROWS, df_chain.LANES), "f64", dev)
           for _ in range(2)]
    dfx = {"f64": tuple(zxy),
           "single": tuple(z.to(torch.complex64) for z in zxy),
           "double_float": tuple(df32.cdf_from_complex128(z) for z in zxy)}
    dfw = {p: (df_chain.twiddle(p, dev), df_chain.shrink(p))
           for p in df_chain.PRECISIONS}
    torch.cuda.synchronize()

    exact_regime = port_config.approx_butterflies
    port_config.approx_butterflies = lambda device: True
    try:
        _build.reset_launches()
        outs6 = {}
        for key, (_, e, x) in sixth.items():
            y = e.forward(x)
            outs6[key] = (y, e.forward(x, 1, 4), e.inverse(y))
        rc6 = rns_poly_mult_mod(ra, rb, n17, moduli)
        chains6 = {s: chain.chain(cx, cy, chain.PROBE_W, chain.PROBE_Q,
                                  chain.REPS, s) for s in ("lean16", "exact")}
        dfs6 = {p: df_chain.chain(*dfx[p], *dfw[p], p)
                for p in df_chain.PRECISIONS}
        torch.cuda.synchronize()
        launches6 = dict(_build.launches)
    finally:
        port_config.approx_butterflies = exact_regime
    log(f"phase 4: sixth main path's launches {launches6}")
    sixth_kernels = ("K1.lean8", "K1.lean16", "K2.lean8", "K5.lean16",
                     "K6.lean16", "K5.rns.lean16", "K6.rns.lean16",
                     "K4.rows.approx", "K17", "K17.exact", "K18.df",
                     "K18.f64", "K18.f32")
    missing = [k for k in sixth_kernels if launches6.get(k, 0) < 1]
    exact_names = [k for k in ("K1", "K2", "K5", "K6", "K5.rns", "K6.rns",
                               "K1.rns.cl", "K6.rns.cl")
                   if k in launches6]
    if missing or exact_names:
        raise AssertionError(f"sixth main path launched no {missing}; exact "
                             f"instantiations {exact_names}")

    # Every output against the plain lean path and, fully reduced, against
    # the exact outputs on the same inputs (after the counts were read).
    for key, (name, e, x) in sixth.items():
        scheme = key.split()[0]
        y, lazy, back = outs6[key]
        fwd_k = ("K6" if e.plan.n > n14 else
                 route(e.plan.n, x.shape[0])) + "." + scheme
        inv_k = ("K5" if e.plan.n > n14 else fwd_k.split(".")[0]) + "." + \
            scheme
        compare(fwd_k, y, torch_ntt.fwd_ntt(x, e.plan, 1, 1, 64, scheme),
                f"sixth path: {name}.forward == the plain lean walk")
        compare(fwd_k, lazy, torch_ntt.fwd_ntt(x, e.plan, 1, 4, 64, scheme),
                f"sixth path: {name}.forward OMF 4 == the plain lean walk")
        compare(inv_k, back, torch_ntt.inv_ntt(y, e.plan, 1, 1, 64, scheme),
                f"sixth path: {name}.inverse == the plain lean walk")
        compare(fwd_k, y, torch_ntt.fwd_ntt(x, e.plan),
                f"sixth path: {name}.forward == the exact output")
        if not torch.equal(back, x):
            raise AssertionError(f"sixth path: {name} round trip failed")
        if int(to_numpy(lazy).max()) >= 4 * e.plan.q:
            raise AssertionError(f"sixth path: {name} OMF 4 out of range")
    for i, plan in enumerate(rns_plans):
        fa, fb = (torch_ntt.fwd_ntt(v[i], plan, 1, 4, 64, "lean16")
                  for v in (ra, rb))
        plain = torch_ntt.inv_ntt(torch_kernels.mult_mod(fa, fb, plan.q, 4),
                                  plan, 1, 1, 64, "lean16")
        compare("K5.rns.lean16", rc6[i], plain,
                f"sixth path: rns_poly_mult_mod prime {i} == the plain lean "
                "path")
    compare("K5.rns.lean16", rc6, rc, "sixth path: rns_poly_mult_mod == the "
            "exact product of the second path")
    for s_, (gx, gy) in chains6.items():
        want = chain.chain_plain(cx, cy, chain.PROBE_W, chain.PROBE_Q,
                                 chain.REPS, s_)
        compare(chain.kernel_name(s_), gx, want[0], f"sixth path: K17 {s_} x")
        compare(chain.kernel_name(s_), gy, want[1], f"sixth path: K17 {s_} y")
    q17 = np.uint64(chain.PROBE_Q)
    if not all(np.array_equal(to_numpy(a) % q17, to_numpy(b) % q17)
               for a, b in zip(chains6["lean16"], chains6["exact"])):
        raise AssertionError("sixth path: the lean16 chain != the exact one "
                             "mod q")
    for p_, (gx, gy) in dfs6.items():
        want = df_chain.chain_plain(*dfx[p_], *dfw[p_], p_)
        compare_fft(df_chain.kernel_name(p_), gx, want[0], p_,
                    f"sixth path: K18 {p_} x")
        compare_fft(df_chain.kernel_name(p_), gy, want[1], p_,
                    f"sixth path: K18 {p_} y")
    z64 = {p_: [df32.cdf_to_complex128(v) if p_ == "double_float" else
                v.to(torch.complex128) for v in dfs6[p_]]
           for p_ in df_chain.PRECISIONS}
    chain_err = {p_: max(float((a - b).abs().max()) for a, b in
                         zip(z64[p_], z64["f64"]))
                 for p_ in ("double_float", "single")}
    log(f"phase 4: every output of the sixth main path == the plain lean path "
        f"and, fully reduced, the exact one; round trips exact; K17 lean16 == "
        f"exact mod q; K18 against its f64 chain: max abs err {chain_err}")
    if chain_err["double_float"] > 1e-12 or chain_err["single"] > 1e-4:
        raise AssertionError(f"K18 chains disagree with f64: {chain_err}")

    # The sixth path's approx runs: the butterflies of the JAX package's
    # Pallas kernels ("approx"), reached through the public entry points
    # with the scheme map forced to them (`torch_ntt.scheme_of`; the JAX
    # package reaches that form through its Pallas backend), and the
    # eltwise family's approximate quotients and PipelineNTT's approx
    # stages with the switch forced on (`config.approx_butterflies`):
    # NTT(2^14, 60-bit) at batch 256 (K1), NTT(2^6, 49-bit) at 8192 (K2),
    # NTT(2^17, 60-bit) at 16 (K5/K6), NTT(2^20, 60-bit) at 2 (K5's tiled
    # form, K6), poly_mult_mod at (2^14, 60-bit, 64) and (2^13, 60-bit, 132)
    # (K3, K3.cta), DistNTT(2^17, 60-bit) on a (1, 8) mesh of cuda:0
    # positions with local_scheme="approx" (K6 with a shard base; its cross
    # pass, K5, exact as the JAX package's), PipelineNTT(2^14, 60-bit) on a
    # ring of 8 (K16), the five eltwise ops with an approximate body at
    # 2^22 elements, and a key switch at N=2^14 x ds 3 (its base
    # conversion, K8.reduce.rows). Counted in a window of their own.
    from hexl_tpu_torch.parallel import (DistNTT, PipelineNTT, make_mesh,
                                         make_pipeline_mesh)
    approx6 = {
        "K1": ("NTT(2^14, 60-bit), batch 256", ntt14, sixth["lean8"][2]),
        "K2": (f"NTT(2^6, 49-bit), batch {PACKED_BATCH}", ntt6,
               sixth["lean8 packed"][2]),
        "K5": ("NTT(2^17, 60-bit), batch 16", NTT(n17, q60_17),
               rand((SPLIT_BATCH, n17), q60_17)),
        "K5.tile": ("NTT(2^20, 60-bit), batch 2", NTT(n20, q60_20),
                    rand((2, n20), q60_20)),
    }
    products6 = {"K3": (n14, rand((64, n14), q60), rand((64, n14), q60)),
                 "K3.cta": (CTA_N, rand((CTA_BATCH, CTA_N), q60),
                            rand((CTA_BATCH, CTA_N), q60))}
    dist6 = DistNTT(n17, q60_17, make_mesh(8, 1, [dev] * 8),
                    local_scheme="approx")
    xd6 = rand((4, n17), q60_17)
    pipe6 = PipelineNTT(n14, q60, make_pipeline_mesh(8, [dev] * 8))
    xp6 = rand((8, 2, n14), q60)
    big6 = 1 << 22
    e6 = {"a": rand((big6,), 4 * q60), "b": rand((big6,), 4 * q60),
          "c": rand((big6,), 4 * q60), "wide": rand((big6,), 1 << 64),
          "r": rand((big6,), q60)}
    fma6 = 0x123456789ABCDEF % q60
    ks6 = key_switch_inputs(rng, n14, (50, 50, 50, 50), 2, dev, nt,
                            to_tensor)
    torch.cuda.synchronize()

    def eltwise6(approx):
        """The five ops with an approximate body, through the public
        functions (the switch as the caller set it)."""
        return {
            "K4": port.eltwise_mult_mod(e6["a"], e6["b"], q60, 4),
            "K8.fma": port.eltwise_fma_mod(e6["a"], fma6, e6["c"], q60, 4),
            "K8.reduce": port.eltwise_reduce_mod(e6["wide"], q60, q60, 2),
            "K8.cmp": port.eltwise_cmp_sub_mod(e6["wide"], q60, "nlt",
                                               1 << 63, 7),
            "K8.mont": port.eltwise_montgomery_form_in(e6["r"], q60)}

    scheme_map = torch_ntt.scheme_of
    torch_ntt.scheme_of = (lambda lean_ok, lean16_ok:
                           "approx" if lean_ok else "exact")
    port_config.approx_butterflies = lambda device: True
    try:
        _build.reset_launches()
        outs6a = {}
        for key, (_, e, x) in approx6.items():
            y = e.forward(x)
            outs6a[key] = (y, e.forward(x, 1, 4), e.inverse(y))
        prods6 = {key: poly_mult_mod(a, b, n, q60)
                  for key, (n, a, b) in products6.items()}
        dist_y = dist6.forward(xd6)
        dist_lazy = dist6.forward(xd6, 1, 4)
        dist_back = dist6.inverse(dist_y)
        pipe_lazy = pipe6.forward(xp6, 1, 4)
        pipe_back = pipe6.inverse(pipe6.forward(xp6), 1, 1)
        elt6 = eltwise6(True)
        ks_out6 = port.key_switch(ks6[0], ks6[1], n14, 3, 4, 4, 2, ks6[3],
                                  ks6[2], ks6[4])
        torch.cuda.synchronize()
        launches6a = dict(_build.launches)
    finally:
        torch_ntt.scheme_of = scheme_map
        port_config.approx_butterflies = exact_regime
    log(f"phase 4: sixth main path's approx launches {launches6a}")
    approx_kernels = ("K1.approx", "K2.approx", "K5.approx", "K6.approx",
                      "K5.tile.approx", "K3.approx", "K3.cta.approx",
                      "K16.approx", "K4.approx", "K8.fma.approx",
                      "K8.reduce.approx", "K8.cmp.approx", "K8.mont.approx",
                      "K8.reduce.rows.approx")
    missing = [k for k in approx_kernels if launches6a.get(k, 0) < 1]
    exact_names = [k for k in ("K1", "K2", "K3", "K3.cta", "K6", "K16",
                               "K4", "K8.fma", "K8.reduce", "K8.mont",
                               "K8.reduce.rows")
                   if k in launches6a]
    if missing or exact_names:
        raise AssertionError(f"sixth main path's approx runs launched no "
                             f"{missing}; exact instantiations "
                             f"{exact_names}")
    # Every output against its plain version in "approx" and, fully
    # reduced, against the exact outputs on the same inputs.
    for key, (name, e, x) in approx6.items():
        y, lazy, back = outs6a[key]
        fwd_k = ("K6" if e.plan.n > n14 else key) + ".approx"
        inv_k = key + ".approx"
        compare(fwd_k, y, torch_ntt.fwd_ntt(x, e.plan, 1, 1, 64, "approx"),
                f"sixth path: {name}.forward == the plain approx walk")
        compare(fwd_k, lazy, torch_ntt.fwd_ntt(x, e.plan, 1, 4, 64,
                                               "approx"),
                f"sixth path: {name}.forward OMF 4 == the plain approx walk")
        compare(inv_k, back, torch_ntt.inv_ntt(y, e.plan, 1, 1, 64,
                                               "approx"),
                f"sixth path: {name}.inverse == the plain approx walk")
        compare(fwd_k, y, torch_ntt.fwd_ntt(x, e.plan),
                f"sixth path: {name}.forward == the exact output")
        if not torch.equal(back, x):
            raise AssertionError(f"sixth path: {name} approx round trip "
                                 "failed")
    for key, (n, a, b) in products6.items():
        plan = get_plan(n, q60)
        compare(key + ".approx", prods6[key],
                poly.poly_mult_plain(a, b, plan, "approx"),
                f"sixth path: poly_mult_mod n={n} == the plain approx chain")
        compare(key + ".approx", prods6[key], poly.poly_mult(a, b, plan),
                f"sixth path: poly_mult_mod n={n} == the exact K3")
    dist_cpu = DistNTT(n17, q60_17, make_mesh(8, 1, ["cpu"] * 8),
                       local_scheme="approx")
    compare("K6.approx", dist_lazy,
            dist_cpu.forward(xd6.cpu(), 1, 4).to(dev),
            "sixth path: DistNTT approx OMF 4 == its plain version")
    compare("K6.approx", dist_y, cuda_ntt.fwd_ntt(xd6, e17.plan),
            "sixth path: DistNTT approx == the exact transform")
    if not torch.equal(dist_back, xd6):
        raise AssertionError("sixth path: DistNTT approx round trip failed")
    compare("K16.approx", pipe_lazy,
            pipeline.stages_plain(xp6, plan14, True, 0, plan14.log_n, 4,
                                  "approx"),
            "sixth path: PipelineNTT approx OMF 4 == the plain approx walk")
    if not torch.equal(pipe_back, xp6):
        raise AssertionError("sixth path: PipelineNTT approx round trip "
                             "failed")
    wp6 = nt.barrett_factor(fma6, 64, q60)
    plain6 = {
        "K4": torch_kernels.mult_mod(e6["a"], e6["b"], q60, 4, True),
        "K8.fma": torch_kernels.fma_mod_preconned(e6["a"], fma6, wp6,
                                                  e6["c"], q60, 4, True),
        "K8.reduce": torch_kernels.reduce_mod(e6["wide"], q60, q60, 2, True),
        "K8.cmp": torch_kernels.cmp_sub_mod(e6["wide"], q60, "nlt", 1 << 63,
                                            7, True),
        "K8.mont": torch_kernels.montgomery_form_in(e6["r"], q60, True)}
    exact6 = eltwise6(False)
    for key, got in elt6.items():
        compare(key + ".approx", got, plain6[key],
                f"sixth path: {key} approx == its plain body")
        if key != "K8.reduce":
            compare(key + ".approx", got, exact6[key],
                    f"sixth path: {key} approx == the exact op (fully "
                    "reduced)")
    compare("K8.reduce.rows.approx", ks_out6, ks.key_switch_plain(
        ks6[0], ks6[1], n14, 3, 4, 4, 2, ks6[3], ks6[2], ks6[4]),
        "sixth path: key switch with the approximation on == the plain "
        "key switch")
    log("phase 4: every output of the sixth path's approx runs == its plain "
        "approx version and, fully reduced, the exact one; round trips "
        "exact")

    # The sixth path's composite runs: the composites' approximate
    # quotients and K3's lean forms through the public entry points, the
    # switch forced on (`config.approx_butterflies`), as the JAX package
    # takes them under its switch: dyadic_multiply at N=2^17 x 16 primes of
    # 50 bits and lr_mat_vec_mult at 2^14 x 4 primes x 16 weights
    # (K9.approx); key_switch at N=2^15 x ds 14 over 49-bit decomposition
    # primes and a 55-bit key prime (rows of two bit lengths: the JAX
    # per-row flush, K10.approx; K11.approx; the block's base conversion
    # in its cross pass's load, K5.rns.conv.approx); poly_mult_mod at (2^14, 64) and (2^13, 132)
    # for a 60-bit q (lean8: K3.lean8, K3.cta.lean8) and a 59-bit q (lean16:
    # K3.lean16, K3.cta.lean16); dist_key_switch at 2^14 x ds 3 on a (2, 4)
    # mesh of cuda:0 positions (the JAX mesh key switch's per-row flush on
    # every position: K10.approx, K11.approx). Counted in a window of their
    # own; every output against the same call with the switch off, and the
    # products against the plain lean chain.
    from hexl_tpu_torch.parallel import dist_key_switch
    dy6 = [torch.stack([torch.stack([rand((n17,), q) for q in moduli])
                        for _ in range(2)]) for _ in range(2)]
    lr_moduli = nt.generate_primes(4, 50, True, ntt_size=n14)
    lr6 = [torch.stack([torch.stack([torch.stack([
        rand((n14,), q) for q in lr_moduli]) for _ in range(2)])
        for _ in range(LR_WEIGHTS)]) for _ in range(2)]
    ks_n6, ks_ds6 = KS_SHAPES[-1]
    ks6c = key_switch_inputs(rng, ks_n6, (49,) * ks_ds6 + (55,), 2, dev, nt,
                             to_tensor)
    dks6 = key_switch_inputs(rng, n14, (49,) * 4, 2, dev, nt, to_tensor)
    mesh6c = make_mesh(4, 2, [dev] * 8)
    products6c = {"K3.lean8": (n14, q60, 64),
                  "K3.cta.lean8": (CTA_N, q60, CTA_BATCH),
                  "K3.lean16": (n14, q59, 64),
                  "K3.cta.lean16": (CTA_N, q59, CTA_BATCH)}
    prods_in6c = {k: (n, q, rand((b, n), q), rand((b, n), q))
                  for k, (n, q, b) in products6c.items()}
    kernel_of6c = {"dyadic_multiply": "K9.approx",
                   "lr_mat_vec_mult": "K9.approx",
                   "key_switch": "K10.approx",
                   "dist_key_switch": "K11.approx"}
    torch.cuda.synchronize()

    def composites6():
        """The calls of the window (the switch as the caller set it)."""
        out = {
            "dyadic_multiply": port.dyadic_multiply(*dy6, moduli),
            "lr_mat_vec_mult": port.lr_mat_vec_mult(*lr6, lr_moduli),
            "key_switch": port.key_switch(
                ks6c[0], ks6c[1], ks_n6, ks_ds6, ks_ds6 + 1, ks_ds6 + 1, 2,
                ks6c[3], ks6c[2], ks6c[4]),
            "dist_key_switch": dist_key_switch(
                dks6[0], dks6[1], n14, 3, 4, 4, 2, dks6[3], dks6[2], dks6[4],
                mesh6c)}
        for key, (n, q, a, b) in prods_in6c.items():
            out[key] = poly_mult_mod(a, b, n, q)
        return out

    port_config.approx_butterflies = lambda device: True
    try:
        _build.reset_launches()
        outs6c = composites6()
        torch.cuda.synchronize()
        launches6c = dict(_build.launches)
    finally:
        port_config.approx_butterflies = exact_regime
    log(f"phase 4: sixth main path's composite launches {launches6c}")
    # Two dyadic products; one key switch (one flush, a spread and a fold)
    # and the mesh key switch's 8 positions (8 flushes, 8 spreads, 8
    # folds); each product one launch.
    want6c = {"K9.approx": 2, "K10.approx": 1 + 8, "K11.approx": 2 + 16,
              "K3.lean8": 1, "K3.cta.lean8": 1, "K3.lean16": 1,
              "K3.cta.lean16": 1}
    wrong = {k: launches6c.get(k, 0) for k, v in want6c.items()
             if launches6c.get(k, 0) != v}
    exact_names = [k for k in ("K9", "K10", "K11", "K3", "K3.cta",
                               "K5.rns.conv", "K8.reduce")
                   if k in launches6c]
    if wrong or exact_names or not launches6c.get("K5.rns.conv.approx"):
        raise AssertionError(f"sixth path's composite runs: launches {wrong} "
                             f"(want {want6c}); exact instantiations "
                             f"{exact_names}")
    exact6c = composites6()
    for key, got in outs6c.items():
        compare(kernel_of6c.get(key, key), got, exact6c[key],
                f"sixth path: {key} with the switch on == off")
    for key, (n, q, a, b) in prods_in6c.items():
        compare(key, outs6c[key], poly.poly_mult_plain(
            a, b, get_plan(n, q), key.split(".")[-1]),
            f"sixth path: poly_mult_mod {key} == the plain lean chain")
    log("phase 4: every output of the sixth path's composite runs == the "
        "same call with the switch off; the products == the plain lean "
        "chain")

    # The seventh: the host-side modules through their entry points
    # (seventh_path): prewarm and the first public pair of each of
    # SEVENTH_CONFIGS in a fresh process, against the same pair in a
    # process that was not prewarmed; the plan file saved in one process and
    # loaded in another (with the host library and without), its first pairs
    # against freshly built plans'; examples/example_torch.py on the card;
    # a profiler trace of the graft pipeline, the N=2^15 x ds 14 key switch
    # and one eltwise call, broken down per call.
    launches7 = seventh_path(rng, dev, compare)
    log(f"phase 4: seventh main path's launches {launches7}")

    # -- 5. timings ---------------------------------------------------------
    def graph_ms(fn, inner):
        """Median device ms of one call of fn over 20 replays of a CUDA
        graph holding `inner` calls (no host gaps between launches)."""
        return statistics.median(graph_times(fn, inner))

    def forced_ms(module, rule, p, fn, inner):
        """graph_ms with P polynomials (transforms) per CTA instead of
        what the packing rule `module.rule` (its second argument the
        batch) gives."""
        choose = getattr(module, rule)
        setattr(module, rule, lambda *args: min(p, args[1]))
        try:
            return graph_ms(fn, inner)
        finally:
            setattr(module, rule, choose)

    imad_rate = SMS * INT32_LANES_PER_SM * sm_mhz * 1e6
    per_shoup = imads["mulhi64"] + 2 * imads["mullo64"]
    per_shoup32 = imads["mulhi32"] + 2 * imads["mullo32"]
    per_barrett = 2 * imads["mulhi64"] + 2 * imads["mullo64"]
    # The Barrett product with the approximate quotient (mulhi64_approx).
    per_barrett_a = (imads["mulhi64"] + imads["mulhi64a"]
                     + 2 * imads["mullo64"])

    def ntt_imads(n, batch, forward, shoup=per_shoup):
        log_n = n.bit_length() - 1
        stages = log_n if forward else log_n + 1   # final stage: 2 Shoups
        return batch * stages * (n // 2) * shoup

    def bound(nbytes, nops, rate=None):
        """The larger of the bytes over the memory rate and the operations
        over their rate (32-bit IMADs unless another rate is given)."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / (rate or imad_rate) * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    per_lean = imads["mulhi64a6"] + 2 * imads["mullo64"]

    def lean_imads(butterflies, stages, final):
        """IMADs of `stages` lean stages of `butterflies` butterflies each,
        plus a final inverse stage's two exact Shoup products."""
        return butterflies * (stages * per_lean + (2 * per_shoup if final
                                                   else 0))

    def pair_case(n, q, batch, omf_fwd, scheme="exact"):
        plan = get_plan(n, q)
        x = rand((batch, n), q)
        kernel = lambda: cuda_ntt.inv_ntt(
            cuda_ntt.fwd_ntt(x, plan, 1, omf_fwd, 64, scheme), plan, 1, 1, 64,
            scheme)
        plain = lambda: torch_ntt.inv_ntt(
            torch_ntt.fwd_ntt(x, plan, 1, omf_fwd, 64, scheme), plan, 1, 1,
            64, scheme)
        nbytes = 2 * (2 * 8 * batch * n + 2 * 8 * n)
        if scheme == "exact":
            nimads = ntt_imads(n, batch, True) + ntt_imads(n, batch, False)
        else:
            log_n = n.bit_length() - 1
            nimads = lean_imads(batch * n // 2, 2 * log_n - 1, True)
        return kernel, plain, nbytes, nimads

    k1 = pair_case(n14, q60, 256, 1)
    k2 = pair_case(PACKED_N, q49_6, PACKED_BATCH, 1)
    def product_case(n, q, batch, scheme="exact"):
        """poly_mult: a and b read, the product written, the four tables
        read once; two forwards, one inverse and a Barrett product a
        coefficient (in the other schemes: the approximate butterflies'
        IMADs, the final stage's two exact Shoup products, the Barrett
        product's approximate quotient)."""
        plan = get_plan(n, q)
        pa, pb = rand((batch, n), q), rand((batch, n), q)
        if scheme == "exact":
            nimads = (2 * ntt_imads(n, batch, True)
                      + ntt_imads(n, batch, False))
        else:
            log_n = n.bit_length() - 1
            nimads = lean_imads(batch * n // 2, 3 * log_n - 1, True)
        return (lambda: poly.poly_mult(pa, pb, plan, scheme),
                lambda: poly.poly_mult_plain(pa, pb, plan, scheme),
                3 * 8 * batch * n + 4 * 8 * n,
                nimads + batch * n * (per_barrett if scheme == "exact"
                                      else per_barrett_a))

    k3 = product_case(n14, q60, 64)
    k3c = product_case(CTA_N, q60, CTA_BATCH)
    ea, eb = rand((2, n12), 4 * q50), rand((2, n12), 4 * q50)
    k4 = (lambda: ops.mult_mod(ea, eb, q50, 4),
          lambda: torch_kernels.mult_mod(ea, eb, q50, 4),
          3 * 8 * 2 * n12, 2 * n12 * per_barrett)

    def pass_case(n, q, batch, word, cross, scheme="exact"):
        """One pass of the split, forward on inputs in [0, q) and inverse
        on inputs in [0, 2q) (two launches per call). Bytes: each
        coefficient read and written once per direction, plus the twiddle
        entries the pass reads (D - 1 forward, D - 2 inverse for K5; the
        N - D of its stages and their preconditions for K6). Operations:
        one Shoup per butterfly (exact or lean), two exact ones in the
        inverse's final stage (K5)."""
        plan = get_plan(n, q)
        xf, xi = rand((batch, n), q), rand((batch, n), 2 * q)
        log_d = (n // hier.LOCAL_N).bit_length() - 1
        d = 1 << log_d
        shoup = per_shoup32 if word == 32 else per_shoup
        butterflies = batch * (n // 2)
        if cross:
            xf, xi = (v.view(batch, d, hier.LOCAL_N) for v in (xf, xi))
            run, fwd_plain = hier.cross, hier.cross_fwd_plain
            plain = lambda: (fwd_plain(xf, plan, word, scheme),
                             hier.cross_inv_plain(xi, plan, 1, word, scheme))
            tables = 2 * 8 * (2 * d - 3)
            nimads = (2 * log_d + 1) * butterflies * shoup
            if scheme != "exact":
                nimads = lean_imads(butterflies, 2 * log_d - 1, True)
        else:
            run, fwd_plain = hier.local, hier.local_fwd_plain
            plain = lambda: (fwd_plain(xf, plan, 1, word, scheme),
                             hier.local_inv_plain(xi, plan, word, scheme))
            tables = 2 * 2 * 8 * (n - d)
            nimads = 2 * 14 * butterflies * shoup
            if scheme != "exact":
                nimads = lean_imads(butterflies, 2 * 14, False)
        kernel = lambda: (run(xf, plan, True, 1, word, scheme),
                          run(xi, plan, False, 1, word, scheme))
        return kernel, plain, 2 * 2 * 8 * batch * n + tables, nimads

    k5 = pass_case(n17, q60_17, SPLIT_BATCH, 64, True)
    k6 = pass_case(n17, q60_17, SPLIT_BATCH, 64, False)
    k5s = pass_case(n17, q29_17, SPLIT_BATCH, 32, True)
    k5t = pass_case(n20, q60_20, 2, 64, True)   # the rule's tiled form
    k6s = pass_case(n17, q29_17, SPLIT_BATCH, 32, False)
    plan14s = get_plan(n14, q29_14)
    x7 = rand((256, n14), q29_14)
    k7 = (lambda: cuda_ntt.inv_ntt(cuda_ntt.fwd_ntt(x7, plan14s, word=32),
                                   plan14s, word=32),
          lambda: ntt32.inv_ntt32(ntt32.fwd_ntt32(x7, plan14s), plan14s),
          2 * (2 * 8 * 256 * n14 + 2 * 8 * n14),
          ntt_imads(n14, 256, True, per_shoup32)
          + ntt_imads(n14, 256, False, per_shoup32))

    p6 = cuda_ntt.polys_per_cta(PACKED_N, PACKED_BATCH)
    cases = {
        "K1": ("radix_fwd_kernel+radix_inv_kernel<u64>, 1 poly/CTA",
               "hexl_tpu_torch/csrc/ntt.cu", "hexl_tpu/ntt/pallas_ntt.py:547",
               "fwd OMF1 + inv OMF1 pair, N=2^14, 60-bit q, batch 256", k1),
        "K2": ("radix_packed_fwd_kernel+radix_packed_inv_kernel, P polys/CTA",
               "hexl_tpu_torch/csrc/ntt.cu", "hexl_tpu/ntt/pallas_ntt.py:230",
               f"fwd OMF1 + inv OMF1 pair, N=2^6, 49-bit q, batch "
               f"{PACKED_BATCH} (P={p6})", k2),
        "K3": ("poly_cluster_kernel, a cluster of two CTAs per pair",
               "hexl_tpu_torch/csrc/poly.cu", "hexl_tpu/poly.py:72",
               "poly_mult N=2^14, 60-bit q, batch 64", k3),
        "K3.cta": ("poly_cta_kernel, both operands in one CTA",
                   "hexl_tpu_torch/csrc/poly.cu", "hexl_tpu/poly.py:72",
                   f"poly_mult N=2^13, 60-bit q, batch {CTA_BATCH}", k3c),
        "K4": ("eltwise_kernel (mult_mod, 64-bit)",
               "hexl_tpu_torch/csrc/eltwise.cu",
               "hexl_tpu/eltwise/pallas_kernels.py:65",
               "mult_mod IMF 4, 2x2^12 elements, 50-bit q", k4),
        "K5": ("cross_fwd_kernel+cross_inv_kernel<u64, 3>",
               "hexl_tpu_torch/csrc/ntt_hier.cu", "hexl_tpu/ntt/hier.py:164",
               f"cross pass fwd + inv, N=2^17 (D=8), 60-bit q, batch "
               f"{SPLIT_BATCH}", k5),
        "K5.tile": ("cross_tile_fwd_kernel+cross_tile_inv_kernel<u64, 6>, "
                    "tiles of 64 x 16 through a ring",
                    "hexl_tpu_torch/csrc/cross_tile.cuh",
                    "hexl_tpu/ntt/hier.py:164",
                    "cross pass fwd + inv, N=2^20 (D=64), 60-bit q, batch 2",
                    k5t),
        "K5.u32": ("cross_fwd_kernel+cross_inv_kernel<u32, 3>",
                   "hexl_tpu_torch/csrc/ntt_hier.cu",
                   "hexl_tpu/ntt/hier.py:164",
                   f"cross pass fwd + inv, N=2^17 (D=8), 29-bit q, batch "
                   f"{SPLIT_BATCH}", k5s),
        "K6": ("radix_fwd_kernel+radix_inv_kernel<u64>, 1 shard/CTA",
               "hexl_tpu_torch/csrc/ntt_hier.cu", "hexl_tpu/ntt/hier.py:255",
               f"local pass fwd + inv, N=2^17 (8 shards), 60-bit q, batch "
               f"{SPLIT_BATCH}", k6),
        "K6.u32": ("radix_fwd_kernel+radix_inv_kernel<u32>, 1 shard/CTA",
                   "hexl_tpu_torch/csrc/ntt_hier.cu",
                   "hexl_tpu/ntt/hier.py:255",
                   f"local pass fwd + inv, N=2^17 (8 shards), 29-bit q, "
                   f"batch {SPLIT_BATCH}", k6s),
        "K7": ("radix_fwd_kernel+radix_inv_kernel<u32>, 1 poly/CTA",
               "hexl_tpu_torch/csrc/ntt.cu", "hexl_tpu/ntt/ntt32.py:205",
               "fwd OMF1 + inv OMF1 pair, N=2^14, 29-bit q, batch 256", k7),
    }
    # K8 per family at 2^22 elements, one representative op each (60-bit
    # q, or 29-bit for the single word). Bytes: the operands read and the
    # output written; operations: the 64x64 (or 32x32) products.
    elems = BIG[0] * BIG[1] * BIG[2]
    q60b, q29b = top_modulus(nt, 60, BIG[-1]), top_modulus(nt, 29, BIG[-1])
    hi64, lo64 = imads["mulhi64"], imads["mullo64"]
    hi32, lo32 = imads["mulhi32"], imads["mullo32"]
    e60 = [rand(BIG, q60b) for _ in range(2)]
    e29 = [rand(BIG, q29b) for _ in range(2)]
    e60x8 = [rand(BIG, 8 * q60b) for _ in range(2)]
    e29x8 = [rand(BIG, 8 * q29b) for _ in range(2)]
    e64 = rand(BIG, 1 << 64)
    w60 = (12345, nt.barrett_factor(12345, 64, q60b))
    w29 = (12345, nt.barrett_factor(12345, 32, q29b))
    k8_cases = {
        "K8.add_sub": ("add_mod vector, 60-bit",
                       lambda: ops.add_mod(*e60, q60b),
                       lambda: torch_kernels.add_mod(*e60, q60b), 3, 0),
        "K8.add_sub.u32": ("add_mod vector, 29-bit",
                           lambda: ops.add_mod(*e29, q29b, 32),
                           lambda: torch_kernels32.add_mod32(*e29, q29b),
                           3, 0),
        "K8.mult.u32": ("mult_mod IMF 1, 29-bit",
                        lambda: ops.mult_mod(*e29, q29b, 1, 32),
                        lambda: torch_kernels32.mult_mod32(*e29, q29b, 1),
                        3, 2 * hi32 + 2 * lo32),
        "K8.fma": ("fma_mod IMF 8 with addend, 60-bit",
                   lambda: ops.fma_mod(e60x8[0], *w60, e60x8[1], q60b, 8),
                   lambda: torch_kernels.fma_mod_preconned(
                       e60x8[0], *w60, e60x8[1], q60b, 8), 3,
                   hi64 + 2 * lo64),
        "K8.fma.u32": ("fma_mod IMF 8 with addend, 29-bit",
                       lambda: ops.fma_mod(e29x8[0], *w29, e29x8[1], q29b,
                                           8, 32),
                       lambda: torch_kernels32.fma_mod32_preconned(
                           e29x8[0], *w29, e29x8[1], q29b, 8), 3,
                       hi32 + 2 * lo32),
        "K8.reduce": ("reduce_mod IMF q -> OMF 1, 60-bit",
                      lambda: ops.reduce_mod(e64, q60b, q60b, 1),
                      lambda: torch_kernels.reduce_mod(e64, q60b, q60b, 1),
                      2, hi64 + lo64),
        "K8.reduce.u32": ("reduce_mod IMF 4 -> OMF 1, 29-bit",
                          lambda: ops.reduce_mod(e29[0], q29b, 4, 1, 32),
                          lambda: torch_kernels32.reduce_mod32(e29[0], q29b,
                                                               4, 1), 2, 0),
        "K8.cmp": ("cmp_sub_mod nlt, 60-bit",
                   lambda: ops.cmp_sub_mod(e64, q60b, "nlt", 1 << 63, 42),
                   lambda: torch_kernels.cmp_sub_mod(e64, q60b, "nlt",
                                                     1 << 63, 42),
                   2, hi64 + lo64),
        "K8.mont": ("montgomery_mult_reduce, 60-bit",
                    lambda: ops.montgomery_mult_reduce(*e60, q60b),
                    lambda: torch_kernels.montgomery_mult_reduce(*e60, q60b),
                    3, 2 * hi64 + 3 * lo64),
    }
    for name, (op, kernel, plain, words, per_elem) in k8_cases.items():
        cases[name] = (f"eltwise_kernel ({op})",
                       "hexl_tpu_torch/csrc/eltwise.cu",
                       "hexl_tpu/eltwise/pallas_kernels.py:65",
                       f"{op}, 2^22 elements",
                       (kernel, plain, 8 * words * elems, per_elem * elems))
    # K9: dyadic_multiply at N=2^17 x 16 primes (4 words read, 3 written,
    # four Barrett products per coefficient).
    dx, dy = (torch.stack([torch.stack([rand((n17,), q) for q in moduli])
                           for _ in range(2)])[None] for _ in range(2))
    dcon = dyadic.row_constants(tuple(moduli), dev)
    mn = RNS_PRIMES * n17
    cases["K9"] = ("dyadic_kernel", "hexl_tpu_torch/csrc/dyadic.cu",
                   "hexl_tpu/experimental/dyadic.py:92 (XLA-fused jnp; no "
                   "pallas_call)", f"dyadic_multiply N=2^17 x {RNS_PRIMES} "
                   "primes of 50 bits",
                   (lambda: dyadic.dyadic(dx, dy, moduli),
                    lambda: dyadic.dyadic_plain(dx, dy, dcon),
                    8 * 7 * mn, 4 * mn * per_barrett))
    # K10 and K11 at the key switch of N=2^15 x ds 14, kc 2.
    ks_n, ks_ds = KS_SHAPES[-1]
    result, _, keys, ks_moduli, msf = key_switch_inputs(
        rng, ks_n, (49,) * (ks_ds + 1), 2, dev, nt, to_tensor)
    kcon = ks.constants(tuple(ks_moduli), tuple(msf), ks_ds, dev)
    rows_ = ks_ds + 1
    tq = torch.stack([rand((ks_ds, ks_n), 4 * q) for q in ks_moduli])
    tq_parts = block_parts(tq, ks_ds)
    tpp = ks.mac_flush_parts(*tq_parts, keys, kcon, ks_ds, 2, rows_)
    xl = rand((2, ks_n), 2 * ks_moduli[-1])
    tntt = torch.stack([rand((2, ks_n), 4 * q) for q in ks_moduli[:ks_ds]])
    out_words = rows_ * 2 * ks_n
    cases["K10"] = (
        "mac_flush_parts_kernel", "hexl_tpu_torch/csrc/key_switch.cu",
        "hexl_tpu/experimental/key_switch.py:172-224 (XLA-fused jnp; no "
        "pallas_call)", f"key-switch MAC + flush, N=2^15, ds {ks_ds}, kc 2",
        (lambda: ks.mac_flush_parts(*tq_parts, keys, kcon, ks_ds, 2, rows_),
         lambda: ks.mac_flush_plain(tq, keys, kcon.mac, ks_ds, 2, rows_),
         8 * (rows_ * ks_ds * ks_n + keys.numel() + out_words),
         out_words * (ks_ds * (hi64 + lo64) + 2 * (hi64 + lo64)
                      + per_barrett)))
    md_words = ks_ds * 2 * ks_n
    cases["K11"] = (
        "spread_kernel+fold_kernel", "hexl_tpu_torch/csrc/key_switch.cu",
        "hexl_tpu/experimental/key_switch.py:226-284 (XLA-fused jnp; no "
        "pallas_call)", f"key-switch mod-down spread + fold, N=2^15, "
        f"ds {ks_ds}, kc 2",
        (lambda: (ks.spread(xl, kcon), ks.fold(result, tpp, tntt, kcon)),
         lambda: (ks.spread_plain(xl, kcon),
                  ks.fold_plain(result, tpp, tntt, kcon)),
         8 * (2 * ks_n + md_words + 4 * md_words),
         md_words * (2 * (hi64 + lo64) + hi64 + 2 * lo64)))
    # The stacked transform at the main paths' shapes: K1.rns's pair at
    # (2^14, 16 primes of 50 bits, batch 16) (the first path's RnsNTT),
    # K2.rns's at (2^6, 3 primes, batch 4096); the split's passes at the RNS
    # product's (2^17, 16 primes, batch 1), K5.rns and K6.rns forward +
    # inverse; K5.rns's tiled form at (2^20, 16 primes, batch 1); K4.rows at
    # the RNS product's (16, 2^17), IMF 4; K8.reduce.rows at the 2^15 x ds
    # 14 key switch's (14, 13, 2^15) block. Bytes: each coefficient read and
    # written once per direction and each row's tables once; operations
    # as the single-modulus rows.
    def rns_pair_case(n, k, batch, bits):
        basis = nt.generate_primes(k, bits, True, ntt_size=n)
        rplan = rns.get_rns_plan(n, basis)
        x = torch.stack([rand((batch, n), q) for q in basis])
        return (lambda: rns.inv_ntt_rns(rns.fwd_ntt_rns(x, rplan), rplan),
                lambda: rns.inv_ntt_rns_plain(rns.fwd_ntt_rns_plain(
                    x, rplan), rplan),
                2 * (2 * 8 * k * batch * n + 2 * 8 * k * n),
                ntt_imads(n, k * batch, True) + ntt_imads(n, k * batch,
                                                          False))

    def rns_pass_case(n, k, batch, cross, scheme="exact", bits=60):
        basis = nt.generate_primes(k, bits, True, ntt_size=n)
        rplan = rns.get_rns_plan(n, basis)
        rows = rplan.descriptors(dev)
        xf = torch.stack([rand((batch, n), q) for q in basis])
        xi = torch.stack([rand((batch, n), 2 * q) for q in basis])
        log_d = (n // hier.LOCAL_N).bit_length() - 1
        d = 1 << log_d
        butterflies = k * batch * (n // 2)
        blocks = (batch, d, hier.LOCAL_N)

        def each(fn, x, *args):
            return torch.stack([fn(x[i], p, *args)
                                for i, p in enumerate(rplan.plans)])
        if cross:
            run = rns._cross
            plain = lambda: (
                each(lambda v, p: hier.cross_fwd_plain(v.view(blocks), p, 64,
                                                       scheme), xf),
                each(lambda v, p: hier.cross_inv_plain(v.view(blocks), p, 1,
                                                       64, scheme), xi))
            tables = k * 2 * 8 * (2 * d - 3)
            nimads = (2 * log_d + 1) * butterflies * per_shoup
            if scheme != "exact":
                nimads = lean_imads(butterflies, 2 * log_d - 1, True)
        else:
            run = rns._local
            plain = lambda: (each(hier.local_fwd_plain, xf, 1, 64, scheme),
                             each(hier.local_inv_plain, xi, 64, scheme))
            tables = k * 2 * 2 * 8 * (n - d)
            nimads = 2 * 14 * butterflies * per_shoup
            if scheme != "exact":
                nimads = lean_imads(butterflies, 2 * 14, False)
        kernel = lambda: (run(xf, rows, rplan, batch, True, 1, scheme),
                          run(xi, rows, rplan, batch, False, 1, scheme))
        return kernel, plain, 2 * 2 * 8 * k * batch * n + tables, nimads

    r_mult = [torch.stack([rand((n17,), 4 * q) for q in moduli])
              for _ in range(2)]
    r_red = rand((ks_ds, ks_ds - 1, ks_n), 1 << 64)
    r_red_moduli = ks_moduli[:ks_ds]
    rcon = ops.row_constants(tuple(moduli), dev)
    rcon_red = ops.row_constants(tuple(r_red_moduli), dev)
    stacked_cases = {
        "K1.rns": ("radix_fwd_rns_kernel+radix_inv_rns_kernel, a row's "
                   "polynomial per CTA", "hexl_tpu_torch/csrc/ntt_rns.cu",
                   "hexl_tpu/ntt/pallas_ntt.py:547",
                   f"RnsNTT fwd + inv, N=2^14, {RNS_PRIMES} primes of 50 "
                   f"bits, batch {SPLIT_BATCH}",
                   rns_pair_case(n14, RNS_PRIMES, SPLIT_BATCH, 50)),
        "K2.rns": ("radix_packed_fwd_rns_kernel+radix_packed_inv_rns_kernel"
                   ", P polys of a row per CTA",
                   "hexl_tpu_torch/csrc/ntt_rns.cu",
                   "hexl_tpu/ntt/pallas_ntt.py:230",
                   f"RnsNTT fwd + inv, N=2^6, 3 primes of 49 bits, batch "
                   f"{PACKED_BATCH // 2}",
                   rns_pair_case(PACKED_N, 3, PACKED_BATCH // 2, 49)),
        "K5.rns": ("cross_fwd_rns_kernel+cross_inv_rns_kernel<3>, column "
                   "form", "hexl_tpu_torch/csrc/cross_rns.cu",
                   "hexl_tpu/ntt/hier.py:164",
                   f"cross pass fwd + inv, N=2^17 (D=8), {RNS_PRIMES} primes "
                   "of 60 bits, batch 1",
                   rns_pass_case(n17, RNS_PRIMES, 1, True)),
        "K5.tile.rns": ("cross_tile_fwd_rns_kernel+cross_tile_inv_rns_kernel"
                        "<6>, per-row groups of persistent CTAs",
                        "hexl_tpu_torch/csrc/cross_rns.cu",
                        "hexl_tpu/ntt/hier.py:164",
                        f"cross pass fwd + inv, N=2^20 (D=64), {RNS_PRIMES} "
                        "primes of 60 bits, batch 1",
                        rns_pass_case(n20, RNS_PRIMES, 1, True)),
        "K6.rns": ("radix_fwd_rns_kernel+radix_inv_rns_kernel, a row's "
                   "shard per CTA", "hexl_tpu_torch/csrc/ntt_rns.cu",
                   "hexl_tpu/ntt/hier.py:255",
                   f"local pass fwd + inv, N=2^17 (8 shards), {RNS_PRIMES} "
                   "primes of 60 bits, batch 1",
                   rns_pass_case(n17, RNS_PRIMES, 1, False)),
        "K5.rns.lean16": ("cross_fwd_rns_kernel+cross_inv_rns_kernel<1, 3>,"
                          " lean16", "hexl_tpu_torch/csrc/cross_rns.cu",
                          "hexl_tpu/ntt/hier.py:164",
                          f"cross pass fwd + inv, N=2^17 (D=8), "
                          f"{RNS_PRIMES} primes of 50 bits, batch 1",
                          rns_pass_case(n17, RNS_PRIMES, 1, True, "lean16",
                                        50)),
        "K6.rns.lean16": ("radix_fwd_rns_kernel+radix_inv_rns_kernel<1>, "
                          "lean16", "hexl_tpu_torch/csrc/ntt_rns.cu",
                          "hexl_tpu/ntt/hier.py:255",
                          f"local pass fwd + inv, N=2^17 (8 shards), "
                          f"{RNS_PRIMES} primes of 50 bits, batch 1",
                          rns_pass_case(n17, RNS_PRIMES, 1, False, "lean16",
                                        50)),
        "K4.rows": ("eltwise_rows_kernel (mult_mod, per-row moduli)",
                    "hexl_tpu_torch/csrc/eltwise.cu",
                    "hexl_tpu/eltwise/pallas_kernels.py:65",
                    f"mult_mod_rows IMF 4, {RNS_PRIMES} x 2^17, 50-bit q",
                    (lambda: ops.mult_mod_rows(*r_mult, moduli, 4),
                     lambda: torch_kernels.mult_mod_rows(*r_mult, rcon, 4),
                     3 * 8 * RNS_PRIMES * n17,
                     RNS_PRIMES * n17 * per_barrett)),
        "K8.reduce.rows": ("eltwise_rows_kernel (reduce_mod IMF q, per-row "
                           "moduli)", "hexl_tpu_torch/csrc/eltwise.cu",
                           "hexl_tpu/eltwise/pallas_kernels.py:65",
                           f"reduce_mod_rows IMF q -> OMF 1, ({ks_ds}, "
                           f"{ks_ds - 1}, 2^15), 49-bit q",
                           (lambda: ops.reduce_mod_rows(r_red, r_red_moduli),
                            lambda: torch_kernels.reduce_mod_rows(r_red,
                                                                  rcon_red),
                            2 * 8 * r_red.numel(),
                            r_red.numel() * (hi64 + lo64))),
    }
    cases.update(stacked_cases)
    # The key switch's base-conversion block as the main path reads it at
    # 2^15 x ds 15 (SEAL's 55-bit BFV primes, the stream cell's top level).
    # K5.rns.conv alone (`rns.conv_cross`) on (15, 2^15) source limbs of
    # any u64 words against the plain gather, row reduction and cross
    # stages; bytes: each limb read once (the limbs sit in the L2, so the
    # loads of the other rows' limbs hit it) and the (15, 14, 2^15) block
    # written once, with each row's forward twiddles; operations: one
    # Barrett reduction a word and the cross stages' Shoup products. K10's
    # row-map form (`ks.mac_flush_parts`, kc 2) on the block's three parts
    # against `ks.mac_flush_parts_plain`; bytes and operations as K10's.
    # Beside K5.rns.conv, the form it took the place of on the same inputs
    # (`replaced_ms`): K5.rns's forward cross pass on the staged block.
    bfv_ds = 15
    bfv_basis = tuple(nt.generate_primes(bfv_ds, 54, False, ntt_size=ks_n))
    bfv_moduli = bfv_basis + tuple(nt.generate_primes(1, 55, False,
                                                      ntt_size=ks_n))
    conv_plan = rns.get_rns_plan(ks_n, bfv_basis)
    conv_rows = conv_plan.descriptors(dev)
    conv_consts = ops.row_constants(bfv_basis, dev)
    conv_x = rand((bfv_ds, ks_n), 1 << 64)
    conv_log_d = ks_n.bit_length() - 1 - hier.LOG_LOCAL
    conv_words = bfv_ds * (bfv_ds - 1) * ks_n
    conv_view = (bfv_ds, bfv_ds - 1, 1 << conv_log_d, hier.LOCAL_N)

    def conv_plain():
        block = torch_kernels.reduce_mod_rows(ks.others(conv_x),
                                              conv_consts, 1).view(conv_view)
        return torch.stack([hier.cross_fwd_plain(block[i], p, 64, "exact")
                            for i, p in enumerate(conv_plan.plans)]).view(
            bfv_ds, bfv_ds - 1, ks_n)

    def conv_kernel():
        return rns.conv_cross(conv_x, conv_rows, conv_plan, conv_consts)

    compare("K5.rns.conv", conv_kernel(), conv_plain(),
            "K5.rns.conv alone, (15, 14, 2^15), 55-bit primes")
    compare("K5.rns.conv", rns.fwd_ntt_rns_conv(conv_x, conv_plan,
                                                conv_consts),
            rns.fwd_ntt_rns_conv_plain(conv_x, conv_plan, conv_consts),
            "fwd_ntt_rns_conv, (15, 14, 2^15), 55-bit primes")
    conv_staged = ops.reduce_mod_rows(ks.others(conv_x), bfv_basis)
    part_t = torch.stack([rand((bfv_ds, ks_n), 4 * q) for q in bfv_moduli])
    part_keys = torch.stack([torch.stack([torch.stack([
        rand((ks_n,), q) for q in bfv_moduli]) for _ in range(2)])
        for _ in range(bfv_ds)])
    part_c = ks.constants(bfv_moduli, tuple(
        nt.inverse_mod(bfv_moduli[-1] % q, q) for q in bfv_basis), bfv_ds,
        dev)
    part_off, part_diag, part_last = block_parts(part_t, bfv_ds)
    part_args = (part_keys, part_c, bfv_ds, 2, bfv_ds + 1)
    compare("K10.parts", ks.mac_flush_parts(part_off, part_diag, part_last,
                                            *part_args),
            ks.mac_flush_parts_plain(part_off, part_diag, part_last,
                                     part_keys, part_c.mac, bfv_ds, 2,
                                     bfv_ds + 1),
            "K10's row map, (16, 15, 2^15), kc 2, 55-bit primes")
    part_out = (bfv_ds + 1) * 2 * ks_n
    cases["K5.rns.conv"] = (
        "cross_fwd_conv_rns_kernel, column form, the block's gather and "
        "reduction in its load", "hexl_tpu_torch/csrc/cross_rns.cu",
        "hexl_tpu/experimental/key_switch.py:134-154 (XLA-fused gather and "
        "reduction) + hexl_tpu/ntt/hier.py:164",
        f"key-switch block fwd cross pass, N=2^15 (D=2), ({bfv_ds}, "
        f"{bfv_ds - 1}) of {bfv_ds} 55-bit primes",
        (conv_kernel, conv_plain,
         8 * (bfv_ds * ks_n + conv_words)
         + bfv_ds * 2 * 8 * ((1 << conv_log_d) - 1),
         conv_words * (hi64 + lo64)
         + conv_log_d * (conv_words // 2) * per_shoup))
    cases["K10.parts"] = (
        "mac_flush_parts_kernel, the block read in its three parts",
        "hexl_tpu_torch/csrc/key_switch.cu",
        "hexl_tpu/experimental/key_switch.py:172-224 (XLA-fused jnp; no "
        "pallas_call)", f"key-switch MAC + flush, N=2^15, ds {bfv_ds}, kc 2",
        (lambda: ks.mac_flush_parts(part_off, part_diag, part_last,
                                    *part_args),
         lambda: ks.mac_flush_parts_plain(part_off, part_diag, part_last,
                                          part_keys, part_c.mac, bfv_ds, 2,
                                          bfv_ds + 1),
         8 * (part_t.numel() + part_keys.numel() + part_out),
         part_out * (bfv_ds * (hi64 + lo64) + 2 * (hi64 + lo64)
                     + per_barrett)))
    replaced = {
        "K5.rns.conv": lambda: rns._cross(conv_staged, conv_rows, conv_plan,
                                          bfv_ds - 1, True, 1, "exact")}
    # The cluster form at the key switch's shapes (ds 3): K1.rns.cl's pair
    # at (2^14, 3 primes of 49 bits, batch 1), K6.rns.cl's local pass
    # forward + inverse at (2^15, 3 primes, batch 1), each in clusters of
    # the rule's C (`cluster_pick`); bytes and operations as K1.rns's and
    # K6.rns's, the bound also no less than the launch floor (below).
    def cluster_pick(log_n, ctas):
        """The rule's C, or the largest the card holds for `ctas` clusters
        where the rule keeps C = 1 (the kernel is timed all the same)."""
        c = rns.cluster_for(log_n, ctas, sms, dev)
        return c if c > 1 else max(
            v for v in CLUSTER_SIZES
            if rns.max_active_clusters(log_n, v, dev) >= ctas)

    def forced_call(c, fn):
        def run():
            with forced_clusters(rns, c):
                return fn()
        return run

    ks_basis = nt.generate_primes(3, 49, True, ntt_size=ks_n)
    cl14 = rns.get_rns_plan(n14, ks_basis)
    cl15 = rns.get_rns_plan(ks_n, ks_basis)
    c14, c15 = cluster_pick(14, 3), cluster_pick(14, 6)
    xc14 = torch.stack([rand((1, n14), q) for q in ks_basis])
    xc15f = torch.stack([rand((1, ks_n), 4 * q) for q in ks_basis])
    xc15i = torch.stack([rand((1, ks_n), 2 * q) for q in ks_basis])
    d15 = cl15.descriptors(dev)
    cluster_cases = {
        "K1.rns.cl": (f"rns_cluster_fwd_kernel+rns_cluster_inv_kernel, a "
                      f"cluster of {c14} CTAs a polynomial",
                      "hexl_tpu_torch/csrc/ntt_rns.cu + ntt_cluster.cuh",
                      "hexl_tpu/ntt/pallas_ntt.py:547",
                      "RnsNTT fwd + inv, N=2^14, 3 primes of 49 bits, batch "
                      "1 (the key switch's stacked inverse at ds 3)",
                      (forced_call(c14, lambda: rns.inv_ntt_rns(
                          rns.fwd_ntt_rns(xc14, cl14), cl14)),
                       lambda: rns.inv_ntt_rns_cluster_plain(
                           rns.fwd_ntt_rns_cluster_plain(xc14, cl14, c14),
                           cl14, c14),
                       2 * (2 * 8 * 3 * n14 + 2 * 8 * 3 * n14),
                       ntt_imads(n14, 3, True) + ntt_imads(n14, 3, False))),
        "K6.rns.cl": (f"rns_cluster_fwd_kernel+rns_cluster_inv_kernel<.., "
                      f"0>, a cluster of {c15} CTAs a 2^14 shard",
                      "hexl_tpu_torch/csrc/ntt_rns.cu + ntt_cluster.cuh",
                      "hexl_tpu/ntt/hier.py:255",
                      "local pass fwd + inv, N=2^15 (2 shards), 3 primes of "
                      "49 bits, batch 1 (the key switch's at ds 3)",
                      (lambda: (rns._cluster(xc15f, d15, cl15, 1, True, 1,
                                             c15),
                                rns._cluster(xc15i, d15, cl15, 1, False, 1,
                                             c15)),
                       lambda: (rns._cluster_plain(xc15f, cl15, c15, True, 1,
                                                   False),
                                rns._cluster_plain(xc15i, cl15, c15, False, 1,
                                                   False)),
                       2 * 2 * 8 * 3 * ks_n + 3 * 2 * 2 * 8 * (ks_n - 2),
                       2 * 14 * 3 * (ks_n // 2) * per_shoup)),
    }
    # K6.shard.cl at the fifth path's shape under a wave: the local pass
    # of position 3 of 8 of the RNS product's N = 2^17 (a 50-bit prime,
    # batch 1: L = 2^14, one one-CTA CTA), forward at OMF 4 + inverse, in
    # clusters of the rule's C; bytes and operations as K6.shard's, the
    # bound no less than the launch floor (below).
    ls_n = 1 << 17
    ls_plan = get_plan(ls_n, nt.generate_primes(1, 50, True,
                                                ntt_size=ls_n)[0])
    c_shard = cluster_pick(14, 1)
    xsf = rand((1, n14), 4 * ls_plan.q)
    xsi = rand((1, n14), 2 * ls_plan.q)
    cluster_cases[shard.CLUSTER_NAME] = (
        f"rns_cluster_fwd_kernel+rns_cluster_inv_kernel<.., 0> with a shard "
        f"base, a cluster of {c_shard} CTAs a DistNTT position's shard",
        "hexl_tpu_torch/csrc/ntt_rns.cu + ntt_cluster.cuh",
        "hexl_tpu/parallel/dist_ntt.py:287",
        "local pass fwd (OMF 4) + inv of position 3 of 8, N=2^17, 50-bit "
        "q, batch 1 (L = 2^14; the RNS product on the (2, 8) mesh)",
        (forced_call(c_shard, lambda: (
            shard.local(xsf, ls_plan, 3, 8, True, 4),
            shard.local(xsi, ls_plan, 3, 8, False))),
         lambda: (shard.local_cluster_plain(xsf, ls_plan, 3, 8, True, 4,
                                            c_shard),
                  shard.local_cluster_plain(xsi, ls_plan, 3, 8, False, 1,
                                            c_shard)),
         2 * 2 * 8 * n14 + 2 * 2 * 8 * (n14 - 1),
         2 * 14 * (n14 // 2) * per_shoup))
    cases.update(cluster_cases)
    # K12 and K13 per precision at the fourth path's shape (n = 2^14, batch
    # 64, scale 2^40), each pass forward + inverse, on six inputs in turn
    # (`rotating`), so that a graph's launches read more than the 50 MB L2
    # holds, as a caller streaming fresh slots would. Bytes: every
    # coefficient read and written once per direction, and the table
    # entries the pass reads; operations: fft_pass_ops, over the
    # FP64 lanes (f64) or the FP32 lanes (single, double-float) at the
    # maximum SM clock. The nearest library call, torch.fft.fft + ifft of
    # the whole transform at the same (batch, n), computes another
    # function (natural order, no twist); it is timed beside, never used.
    d_fft = FFT_N // cuda_fft.BLOCK_N
    nearest = {}
    for prec in FFT_PRECISIONS:
        e = engines["auto" if prec == "f64" else prec]
        fwd_t, inv_t = e.tables(dev)
        nxt = rotating([fft_value(rng, (FFT_BATCH, FFT_N), prec, dev)
                        for _ in range(6)])
        sf, si = e.fused_scale(True), e.fused_scale(False)
        coef = 8 if prec == "single" else 16
        lanes = FP64_LANES_PER_SM if prec == "f64" else FP32_LANES_PER_SM
        rate = SMS * lanes * sm_mhz * 1e6
        z = fft_value(rng, (FFT_BATCH, FFT_N),
                      "single" if prec == "single" else "f64", dev)
        nearest[prec] = {
            "call": f"torch.fft.fft + torch.fft.ifft, {z.dtype}, whole "
                    "transform (not the same function)",
            "ms": graph_ms(lambda: torch.fft.ifft(torch.fft.fft(z)), 20)}
        for kernel, run, plain, tab in (
                ("K13", cuda_fft.cross, cuda_fft.cross_plain, d_fft),
                ("K12", cuda_fft.block, cuda_fft.block_plain, FFT_N)):
            nops = sum(fft_pass_ops(prec, FFT_N, FFT_BATCH, cuda_fft.BLOCK_N,
                                    forward, kernel == "K13", True)
                       for forward in (True, False))
            name = cuda_fft.kernel_name(kernel, prec)
            desc = ("fft_cross_kernel" if kernel == "K13"
                    else "fft_radix_fwd_kernel+fft_radix_inv_kernel, 1 "
                         "block of a split/CTA")
            cases[name] = (
                f"{desc} ({prec})", "hexl_tpu_torch/csrc/fft.cu",
                "hexl_tpu/experimental/pallas_fft.py:183",
                f"{'cross' if kernel == 'K13' else 'block'} pass fwd + inv, "
                f"n=2^14, batch {FFT_BATCH}, scale 2^40",
                (lambda run=run, nxt=nxt, fwd_t=fwd_t, inv_t=inv_t, sf=sf,
                 si=si, prec=prec: (run(nxt(), fwd_t, sf, prec, True),
                                    run(nxt(), inv_t, si, prec, False)),
                 lambda plain=plain, nxt=nxt, fwd_t=fwd_t, inv_t=inv_t, sf=sf,
                 si=si, prec=prec: (plain(nxt(), fwd_t, sf, prec, True),
                                    plain(nxt(), inv_t, si, prec, False)),
                 2 * (2 * coef * FFT_BATCH * FFT_N + coef * tab),
                 nops, rate, nearest[prec]))
    # K14 and K15 on the planes of the forward's first pass at bench.py's
    # shape (N = 2^14, 60-bit q, batch 256): dw int32 planes read and 8
    # bytes written per value (and K14's four tables); operations: K14's
    # two Shoup products, K15's one and a Barrett step. The pass's digit
    # product, torch._int_mm, is timed beside as the matmul's library time.
    mplan = get_mxu_plan(n14, q60)
    mtabs = mplan.tensors(dev)
    mx = rand((256, n14), q60).reshape(256, mplan.n2, mplan.n1)
    mx = mx.permute(1, 0, 2).contiguous()
    mdigits = mxu_ntt.split_digits(mx, mplan.dx_fwd).t()
    mplanes = torch._int_mm(mtabs["wa"], mdigits)
    values = 256 * n14
    int_mm = {"call": "torch._int_mm of the pass's int8 digit planes "
                      f"({tuple(mtabs['wa'].shape)} x {tuple(mdigits.shape)})",
              "ms": graph_ms(lambda: torch._int_mm(mtabs["wa"], mdigits), 20)}
    cases["K14"] = (
        "mxu_fold_twiddle_kernel", "hexl_tpu_torch/csrc/mxu.cu",
        "hexl_tpu/ntt/mxu_ntt.py:541", "forward pass-1 fold + twiddle, "
        "N=2^14, 60-bit q, batch 256",
        (lambda: mxu_ntt.fold_twiddle(mplanes, mplan, mtabs["t_tab"],
                                      mtabs["rho_t_tab"], mplan.n2, mplan.n1),
         lambda: mxu_ntt.fold_twiddle_plain(mplanes, mplan, mtabs["t_tab"],
                                            mtabs["rho_t_tab"], mplan.n2,
                                            mplan.n1),
         4 * mplanes.numel() + 8 * values + 4 * 8 * n14,
         2 * values * per_shoup, None, int_mm))
    cases["K15"] = (
        "mxu_fold_final_kernel", "hexl_tpu_torch/csrc/mxu.cu",
        "hexl_tpu/ntt/mxu_ntt.py:587", "final fold + Barrett (OMF 1) on the "
        "same planes, N=2^14, 60-bit q, batch 256",
        (lambda: mxu_ntt.fold_final(mplanes, mplan, mplan.n2, 1),
         lambda: mxu_ntt.fold_final_plain(mplanes, mplan, mplan.n2, 1),
         4 * mplanes.numel() + 8 * values,
         values * (per_shoup + imads["mulhi64"] + imads["mullo64"]), None,
         int_mm))
    # The parallel layer's kernels at bench.py's shape on the (1, 8) mesh
    # (2^14, 60-bit, batch 256: a position holds 256 x 2048): one
    # position's local pass (K6 with a shard base, the port of row 10) and
    # its cross pass on the exchanged (256, 8, 256) block (K5 with a column
    # stride), each forward + inverse; and K16, the pipeline's stage, as a
    # whole forward + inverse of one microbatch (16 x 2^14) in 28 launches.
    # Bytes: every coefficient read and written once per launch, and the
    # twiddle entries read; operations: one Shoup per butterfly (two in the
    # final inverse stage).
    d8, l8 = 8, n14 // 8
    xf, xi = rand((256, l8), q60), rand((256, l8), 2 * q60)
    bf, bi = rand((256, d8, l8 // d8), q60), rand((256, d8, l8 // d8), 2 * q60)
    butterflies = 256 * l8 // 2
    cases["K6.shard"] = (
        "radix_fwd_kernel+radix_inv_kernel<u64>, shard base (a DistNTT "
        "position's local pass)", "hexl_tpu_torch/csrc/ntt_hier.cu",
        "hexl_tpu/parallel/dist_ntt.py:287", "local pass fwd + inv of "
        "position 3 of 8, 2^14, 60-bit q, batch 256 (L = 2^11)",
        (lambda: (shard.local(xf, plan14, 3, d8, True, 1),
                  shard.local(xi, plan14, 3, d8, False)),
         lambda: (shard.local_fwd_plain(xf, plan14, 3, d8, 1),
                  shard.local_inv_plain(xi, plan14, 3, d8)),
         2 * 2 * 8 * 256 * l8 + 2 * 2 * 8 * (l8 - 1),
         2 * (l8.bit_length() - 1) * butterflies * per_shoup))
    cases["K5.col"] = (
        "cross_fwd_kernel+cross_inv_kernel<u64, 3>, column stride 256 (a "
        "DistNTT position's cross pass)", "hexl_tpu_torch/csrc/ntt_hier.cu",
        "hexl_tpu/ntt/hier.py:164 (and the jnp cross stages of "
        "hexl_tpu/parallel/dist_ntt.py:152-216)",
        "cross pass fwd + inv on the exchanged (256, 8, 256) block, 2^14, "
        "60-bit q",
        (lambda: (hier.cross(bf, plan14, True),
                  hier.cross(bi, plan14, False, 1)),
         lambda: (hier.cross_fwd_plain(bf, plan14),
                  hier.cross_inv_plain(bi, plan14, 1)),
         2 * 2 * 8 * 256 * l8 + 2 * 8 * (2 * d8 - 3),
         (2 * (d8.bit_length() - 1) + 1) * butterflies * per_shoup))
    xs16 = rand((16, n14), q60)
    cases["K16"] = (
        "stage_kernel, one radix-2 stage per launch",
        "hexl_tpu_torch/csrc/stage.cu",
        "port-only: hexl_tpu/parallel/pipeline.py:80-122 (jnp stages in "
        "shard_map; no pallas_call)",
        "a whole fwd + inv (28 stages) of a 16 x 2^14 microbatch, 60-bit q",
        (lambda: (pipeline.stages(xs16, plan14, True, 0, plan14.log_n, 1),
                  pipeline.stages(xs16, plan14, False, 0, plan14.log_n, 1)),
         lambda: (pipeline.stages_plain(xs16, plan14, True, 0, plan14.log_n,
                                        1),
                  pipeline.stages_plain(xs16, plan14, False, 0, plan14.log_n,
                                        1)),
         2 * plan14.log_n * 2 * 8 * 16 * n14 + 2 * 2 * 8 * n14,
         (2 * plan14.log_n + 1) * 16 * (n14 // 2) * per_shoup))
    # The lean instantiations at the sixth path's shapes (bound: as their
    # exact forms, the lean butterflies' IMADs from the SASS of the
    # approximate quotient), and the chains at the probes' shapes. K17:
    # its four planes read or written once, REPS butterflies an element.
    # K18: its sixteen float32 planes (or four complex ones) read or
    # written once; REPS products and complex adds and subtracts an element
    # and two closing scales, the twiddle split once (FFT_COST), over the
    # FP32 or FP64 lanes.
    lean_replaces = ("hexl_tpu/ntt/jnp_ntt.py:114-212 (the lean16/lean8 "
                     "butterflies of the XLA device body; the TPU kernel "
                     "%s runs the 'lean' form of pallas_ntt.py:53-61)")
    cases["K1.lean8"] = (
        "radix_fwd_kernel+radix_inv_kernel<u64, LEAN8>, 1 poly/CTA",
        "hexl_tpu_torch/csrc/ntt.cu",
        lean_replaces % "hexl_tpu/ntt/pallas_ntt.py:547",
        "fwd OMF1 + inv OMF1 pair, N=2^14, 60-bit q, batch 256, lean8",
        pair_case(n14, q60, 256, 1, "lean8"))
    cases["K1.lean16"] = (
        "radix_fwd_kernel+radix_inv_kernel<u64, LEAN16>, 1 poly/CTA",
        "hexl_tpu_torch/csrc/ntt.cu",
        lean_replaces % "hexl_tpu/ntt/pallas_ntt.py:547",
        "fwd OMF1 + inv OMF1 pair, N=2^14, 59-bit q, batch 256, lean16",
        pair_case(n14, q59, 256, 1, "lean16"))
    cases["K2.lean8"] = (
        "radix_packed_fwd_kernel+radix_packed_inv_kernel<LEAN8>, P "
        "polys/CTA", "hexl_tpu_torch/csrc/ntt.cu",
        lean_replaces % "hexl_tpu/ntt/pallas_ntt.py:230",
        f"fwd OMF1 + inv OMF1 pair, N=2^6, 49-bit q, batch {PACKED_BATCH} "
        f"(P={p6}), lean8",
        pair_case(PACKED_N, q49_6, PACKED_BATCH, 1, "lean8"))
    cases["K5.lean16"] = (
        "cross_fwd_kernel+cross_inv_kernel<u64, LEAN16, 3>",
        "hexl_tpu_torch/csrc/ntt_hier.cu",
        lean_replaces % "hexl_tpu/ntt/hier.py:164",
        f"cross pass fwd + inv, N=2^17 (D=8), 50-bit q, batch {SPLIT_BATCH}, "
        "lean16", pass_case(n17, q50_17, SPLIT_BATCH, 64, True, "lean16"))
    cases["K6.lean16"] = (
        "radix_fwd_kernel+radix_inv_kernel<u64, LEAN16>, 1 shard/CTA",
        "hexl_tpu_torch/csrc/ntt_hier.cu",
        lean_replaces % "hexl_tpu/ntt/hier.py:255",
        f"local pass fwd + inv, N=2^17 (8 shards), 50-bit q, batch "
        f"{SPLIT_BATCH}, lean16",
        pass_case(n17, q50_17, SPLIT_BATCH, 64, False, "lean16"))
    # The approx instantiations at the sixth path's approx shapes, each
    # kernel against its plain version in "approx" (bound: as the exact
    # forms', the approximate butterflies' IMADs from the SASS of
    # mulhi64_approx6, and the eltwise bodies' from that of mulhi64_approx).
    # approx_ab lists each beside its exact form for the A/B of phase 5.
    approx_replaces = ("%s (the 'approx' butterflies of "
                       "pallas_ntt.py:53-61, jnp_ntt.py:66-112, the TPU "
                       "kernel's default for q < 2^61)")
    approx_ab = {}
    for name, desc, source, tpu, shape, case, exact in (
            ("K1.approx", "radix_fwd_kernel+radix_inv_kernel<u64, APPROX>, "
             "1 poly/CTA", "hexl_tpu_torch/csrc/ntt.cu",
             "hexl_tpu/ntt/pallas_ntt.py:547",
             "fwd OMF1 + inv OMF1 pair, N=2^14, 60-bit q, batch 256, approx",
             pair_case(n14, q60, 256, 1, "approx"),
             pair_case(n14, q60, 256, 1)),
            ("K2.approx", "radix_packed_fwd_kernel+radix_packed_inv_kernel"
             "<APPROX>, P polys/CTA", "hexl_tpu_torch/csrc/ntt.cu",
             "hexl_tpu/ntt/pallas_ntt.py:230",
             f"fwd OMF1 + inv OMF1 pair, N=2^6, 49-bit q, batch "
             f"{PACKED_BATCH} (P={p6}), approx",
             pair_case(PACKED_N, q49_6, PACKED_BATCH, 1, "approx"),
             pair_case(PACKED_N, q49_6, PACKED_BATCH, 1)),
            ("K3.approx", "poly_cluster_kernel<APPROX>, a cluster of two "
             "CTAs per pair", "hexl_tpu_torch/csrc/poly.cu",
             "hexl_tpu/poly.py:72",
             "poly_mult N=2^14, 60-bit q, batch 64, approx",
             product_case(n14, q60, 64, "approx"),
             product_case(n14, q60, 64)),
            ("K3.cta.approx", "poly_cta_kernel<APPROX>, both operands in "
             "one CTA", "hexl_tpu_torch/csrc/poly.cu", "hexl_tpu/poly.py:72",
             f"poly_mult N=2^13, 60-bit q, batch {CTA_BATCH}, approx",
             product_case(CTA_N, q60, CTA_BATCH, "approx"),
             product_case(CTA_N, q60, CTA_BATCH)),
            ("K5.approx", "cross_fwd_kernel+cross_inv_kernel<u64, APPROX, 3>",
             "hexl_tpu_torch/csrc/ntt_hier.cu", "hexl_tpu/ntt/hier.py:164",
             f"cross pass fwd + inv, N=2^17 (D=8), 60-bit q, batch "
             f"{SPLIT_BATCH}, approx",
             pass_case(n17, q60_17, SPLIT_BATCH, 64, True, "approx"),
             pass_case(n17, q60_17, SPLIT_BATCH, 64, True)),
            ("K5.tile.approx", "cross_tile_fwd_kernel+cross_tile_inv_kernel"
             "<u64, APPROX, 6>", "hexl_tpu_torch/csrc/ntt_hier.cu",
             "hexl_tpu/ntt/hier.py:164",
             "cross pass fwd + inv, N=2^20 (D=64), 60-bit q, batch 2, approx",
             pass_case(n20, q60_20, 2, 64, True, "approx"),
             pass_case(n20, q60_20, 2, 64, True)),
            ("K6.approx", "radix_fwd_kernel+radix_inv_kernel<u64, APPROX>, "
             "1 shard/CTA", "hexl_tpu_torch/csrc/ntt_hier.cu",
             "hexl_tpu/ntt/hier.py:255",
             f"local pass fwd + inv, N=2^17 (8 shards), 60-bit q, batch "
             f"{SPLIT_BATCH}, approx",
             pass_case(n17, q60_17, SPLIT_BATCH, 64, False, "approx"),
             pass_case(n17, q60_17, SPLIT_BATCH, 64, False))):
        cases[name] = (desc, source, approx_replaces % tpu, shape, case)
        approx_ab[name] = (shape, exact[0], case[0], 10)
    x16a = rand((16, n14), q60)
    cases["K16.approx"] = (
        "stage_kernel<APPROX>, one radix-2 stage per launch",
        "hexl_tpu_torch/csrc/stage.cu",
        "port-only: hexl_tpu/parallel/pipeline.py:80-122 with "
        "jnp_ntt._bflys's approx pair (jnp_ntt.py:96-112)",
        "a whole fwd + inv (28 stages) of a 16 x 2^14 microbatch, 60-bit q, "
        "approx",
        (lambda: (pipeline.stages(x16a, plan14, True, 0, 14, 1, "approx"),
                  pipeline.stages(x16a, plan14, False, 0, 14, 1, "approx")),
         lambda: (pipeline.stages_plain(x16a, plan14, True, 0, 14, 1,
                                        "approx"),
                  pipeline.stages_plain(x16a, plan14, False, 0, 14, 1,
                                        "approx")),
         2 * 14 * 2 * 8 * 16 * n14 + 2 * 2 * 8 * n14,
         lean_imads(16 * (n14 // 2), 2 * 14 - 1, True)))
    approx_ab["K16.approx"] = (
        cases["K16.approx"][3],
        lambda: (pipeline.stages(x16a, plan14, True, 0, 14, 1),
                 pipeline.stages(x16a, plan14, False, 0, 14, 1)),
        cases["K16.approx"][4][0], 2)
    # The eltwise bodies at 2^22 elements (a 2-polynomial ciphertext over 16
    # primes at N = 2^17), 60-bit q; the row ops over 16 primes of 50 bits
    # at N = 2^17 (the RNS product's pointwise step, the key switch's base
    # conversion). Bytes: operands read once, the output written once;
    # operations: the exact 128-bit product's IMADs and the approximate
    # quotient's.
    per_shoup_a = imads["mulhi64a"] + 2 * imads["mullo64"]
    per_reduce_a = imads["mulhi64a"] + imads["mullo64"]
    wp_e = nt.barrett_factor(fma6, 64, q60)
    approx_eltwise = ("hexl_tpu/eltwise/pallas_kernels.py:65 (the "
                      "approximate quotients of jnp_kernels.py:43-49, 84, "
                      "110, 131, 158, 171)")

    def forced(on, fn):
        """fn with `config.approx_butterflies` forced to `on`."""
        def run():
            port_config.approx_butterflies = (
                (lambda device: True) if on else exact_regime)
            try:
                return fn()
            finally:
                port_config.approx_butterflies = exact_regime
        return run

    elt_cases = (
        ("K4.approx", "eltwise_kernel<MultMod<u64, true>>",
         "mult_mod IMF 4", lambda: ops.mult_mod(e6["a"], e6["b"], q60, 4),
         lambda: torch_kernels.mult_mod(e6["a"], e6["b"], q60, 4, True),
         3 * 8 * big6, big6 * per_barrett_a),
        ("K8.fma.approx", "eltwise_kernel<FmaMod<u64, true>>",
         "fma_mod IMF 4 with an addend",
         lambda: ops.fma_mod(e6["a"], fma6, wp_e, e6["c"], q60, 4),
         lambda: torch_kernels.fma_mod_preconned(e6["a"], fma6, wp_e,
                                                 e6["c"], q60, 4, True),
         3 * 8 * big6, big6 * per_shoup_a),
        ("K8.reduce.approx", "eltwise_kernel<ReduceMod<u64, true>>",
         "reduce_mod IMF q -> OMF 2",
         lambda: ops.reduce_mod(e6["wide"], q60, q60, 2),
         lambda: torch_kernels.reduce_mod(e6["wide"], q60, q60, 2, True),
         2 * 8 * big6, big6 * per_reduce_a),
        ("K8.cmp.approx", "eltwise_kernel<CmpSubMod<true>>",
         "cmp_sub_mod nlt 2^63",
         lambda: ops.cmp_sub_mod(e6["wide"], q60, "nlt", 1 << 63, 7),
         lambda: torch_kernels.cmp_sub_mod(e6["wide"], q60, "nlt", 1 << 63,
                                           7, True),
         2 * 8 * big6, big6 * per_reduce_a),
        ("K8.mont.approx", "eltwise_kernel<MontIn<true>>",
         "montgomery_form_in", lambda: ops.montgomery_form_in(e6["r"], q60),
         lambda: torch_kernels.montgomery_form_in(e6["r"], q60, True),
         2 * 8 * big6, big6 * per_barrett_a))
    for name, desc, what, kernel, plain, nbytes, nops in elt_cases:
        cases[name] = (
            desc, "hexl_tpu_torch/csrc/eltwise.cu", approx_eltwise,
            f"{what}, 2^22 elements, 60-bit q",
            (forced(True, kernel), plain, nbytes, nops))
        approx_ab[name] = (cases[name][3], forced(False, kernel),
                           forced(True, kernel), 5)
    # The row ops' approximate instantiations at the exact rows' shapes
    # and inputs.
    for name, desc, exact_name, kernel, plain, nops in (
            ("K4.rows.approx", "eltwise_rows_kernel<MultMod<u64, true>>",
             "K4.rows", lambda: ops.mult_mod_rows(*r_mult, moduli, 4),
             lambda: torch_kernels.mult_mod_rows(*r_mult, rcon, 4, True),
             RNS_PRIMES * n17 * per_barrett_a),
            ("K8.reduce.rows.approx",
             "eltwise_rows_kernel<ReduceMod<u64, true>>", "K8.reduce.rows",
             lambda: ops.reduce_mod_rows(r_red, r_red_moduli),
             lambda: torch_kernels.reduce_mod_rows(r_red, rcon_red, 1, True),
             r_red.numel() * per_reduce_a)):
        shape, case = cases[exact_name][3:]
        cases[name] = (desc, "hexl_tpu_torch/csrc/eltwise.cu",
                       approx_eltwise, shape,
                       (forced(True, kernel), plain, case[2], nops))
        approx_ab[name] = (shape, forced(False, kernel), forced(True, kernel),
                           5)
    # The composites' approximate quotients and K3's lean forms at the
    # exact rows' shapes: K9.approx at N=2^17 x 16 primes (the K9 row's
    # inputs), K10.approx and K11.approx at the 2^15 x ds 14 key switch's
    # (the K10 and K11 rows' inputs, the form passed as the wrappers'
    # argument), K3 and K3.cta in lean16 (a 59-bit q) and lean8 (60-bit) at
    # the K3 rows' shapes, each lean row beside the exact product on the
    # same q; bounds as the exact rows', the approximate quotients' IMADs
    # from the SASS of mulhi64_approx.
    dy_case = cases["K9"][4]
    cases["K9.approx"] = (
        "dyadic_kernel<true>", "hexl_tpu_torch/csrc/dyadic.cu",
        "hexl_tpu/experimental/dyadic.py:46,74 (the approximate quotient of "
        "limb.mult_mod_barrett_traced; XLA-fused jnp, no pallas_call)",
        cases["K9"][3],
        (forced(True, dy_case[0]), lambda: dyadic.dyadic_plain(dx, dy, dcon,
                                                               True),
         dy_case[2], 4 * mn * per_barrett_a))
    approx_ab["K9.approx"] = (cases["K9"][3], forced(False, dy_case[0]),
                              forced(True, dy_case[0]), 5)
    per_reduce_exact = imads["mulhi64"] + imads["mullo64"]
    k10_case = cases["K10"][4]
    cases["K10.approx"] = (
        "mac_flush_parts_kernel<true>", "hexl_tpu_torch/csrc/key_switch.cu",
        "hexl_tpu/experimental/key_switch.py:34-51 (_barrett_reduce_128's "
        "approximate quotients; XLA-fused jnp, no pallas_call)",
        cases["K10"][3],
        (lambda: ks.mac_flush_parts(*tq_parts, keys, kcon, ks_ds, 2, rows_,
                                    True),
         lambda: ks.mac_flush_plain(tq, keys, kcon.mac, ks_ds, 2, rows_,
                                    True),
         k10_case[2],
         k10_case[3] + out_words * (2 * (per_reduce_a - per_reduce_exact)
                                    + per_barrett_a - per_barrett)))
    approx_ab["K10.approx"] = (cases["K10"][3], k10_case[0],
                               cases["K10.approx"][4][0], 5)
    k11_case = cases["K11"][4]
    cases["K11.approx"] = (
        "spread_kernel<true>+fold_kernel<true>",
        "hexl_tpu_torch/csrc/key_switch.cu",
        "hexl_tpu/experimental/key_switch.py:236-282 (the mod-down's "
        "approximate quotients; XLA-fused jnp, no pallas_call)",
        cases["K11"][3],
        (lambda: (ks.spread(xl, kcon, True),
                  ks.fold(result, tpp, tntt, kcon, True)),
         lambda: (ks.spread_plain(xl, kcon, True),
                  ks.fold_plain(result, tpp, tntt, kcon, True)),
         k11_case[2],
         k11_case[3] + md_words * (imads["mulhi64a"] - imads["mulhi64"])))
    approx_ab["K11.approx"] = (cases["K11"][3], k11_case[0],
                               cases["K11.approx"][4][0], 5)
    def lean_product_rows():
        """{name: (cases entry, approx_ab entry)} of K3's lean rows (the
        rule's forms at these shapes: the cluster at 2^14 x 64, the one-CTA
        form at 2^13 x 132)."""
        rows = {}
        for form, n, batch in (("K3", n14, 64), ("K3.cta", CTA_N,
                                                  CTA_BATCH)):
            kernel = ("poly_cluster_kernel" if form == "K3"
                      else "poly_cta_kernel")
            for scheme, q in (("lean16", q59), ("lean8", q60)):
                shape = (f"poly_mult N=2^{n.bit_length() - 1}, "
                         f"{q.bit_length()}-bit q, batch {batch}, {scheme}")
                case = product_case(n, q, batch, scheme)
                exact = product_case(n, q, batch)
                rows[f"{form}.{scheme}"] = (
                    (f"{kernel}<{scheme.upper()}>",
                     "hexl_tpu_torch/csrc/poly.cu",
                     "hexl_tpu/poly.py:72 (_poly_mult_xla's lean butterflies "
                     "and approximate mult_mod, poly.py:93-97)", shape,
                     case),
                    (shape, exact[0], case[0], 10))
        return rows

    for name, (case_row, ab_row) in lean_product_rows().items():
        cases[name] = case_row
        approx_ab[name] = ab_row
    # The chains on six input sets in turn (`rotating`), so that a graph's
    # launches read more than the 50 MB L2 holds, as K12/K13's do.
    chain_elems = chain.ROWS * chain.LANES
    next_cxy = rotating([chain.probe_inputs(rng, dev) for _ in range(6)])
    for s_, per in (("lean16", per_lean), ("exact", per_shoup)):
        cases[chain.kernel_name(s_)] = (
            f"ntt_chain_kernel<{'LEAN16' if s_ == 'lean16' else 'EXACT'}>",
            "hexl_tpu_torch/csrc/chain.cu",
            "benchmarks/mosaic_butterfly_ab.py:93" + (
                "" if s_ == "lean16" else " (its exact-Harvey sibling)"),
            f"{chain.REPS} dependent {s_} butterflies on two "
            f"{chain.ROWS} x {chain.LANES} planes, q = 2^59 - 2^14 + 1",
            (lambda s_=s_: chain.chain(*next_cxy(), chain.PROBE_W,
                                       chain.PROBE_Q, chain.REPS, s_),
             lambda s_=s_: chain.chain_plain(*next_cxy(), chain.PROBE_W,
                                             chain.PROBE_Q, chain.REPS, s_),
             4 * 8 * chain_elems, chain_elems * chain.REPS * per))
    df_elems = df_chain.ROWS * df_chain.LANES
    next_dfx = {p_: rotating([tuple(fft_value(rng, (df_chain.ROWS,
                                                    df_chain.LANES), p_, dev)
                                    for _ in range(2)) for _ in range(6)])
                for p_ in df_chain.PRECISIONS}
    for p_ in df_chain.PRECISIONS:
        c = FFT_COST[p_]
        lanes = FP64_LANES_PER_SM if p_ == "f64" else FP32_LANES_PER_SM
        word = 8 if p_ == "single" else 16
        policy = {"double_float": "DfP", "f64": "F64", "single": "F32"}[p_]
        cases[df_chain.kernel_name(p_)] = (
            f"df_chain_kernel<{policy}>",
            "hexl_tpu_torch/csrc/chain.cu",
            "benchmarks/mosaic_df_bfly_ab.py:85" + (
                "" if p_ == "double_float" else
                f" (the same chain in {p_}, K12's arithmetic)"),
            f"{df_chain.REPS} dependent butterflies and a 2^-8 scale on "
            f"{df_chain.ROWS} x {df_chain.LANES} complex values, {p_}",
            (lambda p_=p_: df_chain.chain(*next_dfx[p_](), *dfw[p_], p_),
             lambda p_=p_: df_chain.chain_plain(*next_dfx[p_](), *dfw[p_],
                                                p_),
             4 * word * df_elems,
             df_elems * (df_chain.REPS * (c["mul"] + 2 * c["add"])
                         + 2 * c["scale"]) + c["split"],
             SMS * lanes * sm_mhz * 1e6, None))
    # Rows 1, 2, 3, 6, 7, 10, 11 (K12) and the lean row's K1/K6 on rotating
    # inputs (`walk_runs`); their plain versions and bounds as above.
    walk = walk_runs(rng, dev, nt, get_plan, cuda_ntt, hier, shard, to_tensor)
    # K4, K8's families, the row ops and K10 likewise (`stream_runs`).
    stream = stream_runs(rng, dev, nt, ops, ks, port_config, to_tensor)
    walk.update({row: fn for row, (fn, _) in stream.items()})
    for name, row in {**WALK_ROWS, **STREAM_ROWS}.items():
        desc, source, replaces, shape, case = cases[name]
        cases[name] = (desc, source, replaces,
                       f"{shape}, inputs rotating beyond the L2",
                       (walk[row],) + tuple(case[1:]))
    # Entries whose launches are counted under another kernel's name: the
    # fifth path's K6 and K5 launches are all DistNTT positions'.
    counted_as = {"K6.shard": "K6", "K5.col": "K5"}
    # K10's two forms share its launch name.
    launch_name = {"K10.parts": "K10"}
    entries = []
    for name, (desc, source, replaces, shape, case) in cases.items():
        kernel, plain, nbytes, nops = case[:4]
        rate, near = (case[4], case[5]) if len(case) > 4 else (None, None)
        ms = graph_ms(kernel, 20)
        plain_ms = graph_ms(plain, 2)
        bound_ms, bound_by = bound(nbytes, nops, rate)
        unit = "IMADs" if rate is None else "FP ops"
        beside = (f"; nearest library {near['call']}: {near['ms']:.4f} ms"
                  if near else "")
        log(f"{name} {desc} at {shape}: {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, "
            f"{nops} {unit}), {bound_ms / ms:.1%} of bound{beside}")
        entry = {
            "name": f"{name} {desc}", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (launches5.get(counted_as[name], 0)
                         if name in counted_as else
                         sum(counts.get(launch_name.get(name, name), 0)
                             for counts in
                             (launches1, launches2, launches3, launches4,
                              launches5, launches6, launches6a,
                              launches6c, launches7))),
            "max_abs_err": float(max_err[name]), "matched": True,
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        if near:
            entry["nearest_library"] = near
        if name in replaced:
            entry["replaced_ms"] = graph_ms(replaced[name], 20)
            log(f"{name}: the form it took the place of, on the same "
                f"inputs, {entry['replaced_ms']:.4f} ms (this form "
                f"{ms / entry['replaced_ms']:.3f}x of it)")
        entries.append(entry)

    # The one PyTorch call that computes a K8.reduce row's function:
    # eltwise_reduce_mod at IMF 2 or 4 with OMF 1 reads values below 4q <
    # 2^63, where torch.remainder(a, q) of the int64 tensor gives the same
    # bits. Timed beside the kernel on the same rotating inputs at 2^22
    # elements (`stream_runs`; held equal on one input here):
    # 60-bit q at IMF 4 (the K8.reduce instantiation; that row's own call,
    # IMF q on any u64, has no such call) and the K8.reduce.u32 row's call,
    # whose entry takes it as its library time.
    r60 = rand(BIG, 4 * q60b)
    for name, x, q, word, rows in (
            ("K8.reduce", r60, q60b, 64, ("K8.reduce.imf4",
                                          "torch.remainder")),
            ("K8.reduce.u32", e29[0], q29b, 32, ("K8.reduce.u32",
                                                 "torch.remainder.u32"))):
        got = ops.reduce_mod(x, q, 4, 1, word)
        compare(name, got, torch.remainder(x, q),
                f"reduce_mod IMF 4 -> OMF 1, {q.bit_length()}-bit == "
                "torch.remainder")
        kernel_ms, library_ms = (graph_ms(walk[row], 20) for row in rows)
        entry = next(e for e in entries if e["name"].startswith(name + " "))
        if name == "K8.reduce.u32":
            entry["library_ms"] = library_ms
        else:
            entry["library_imf4"] = {"call": "torch.remainder",
                                     "kernel_ms": kernel_ms,
                                     "library_ms": library_ms}
        log(f"{name} reduce_mod IMF 4 -> OMF 1, {q.bit_length()}-bit, 2^22 "
            f"elements: kernel {kernel_ms:.4f} ms, torch.remainder "
            f"{library_ms:.4f} ms (library/kernel "
            f"{library_ms / kernel_ms:.3f})")

    # The cluster form's launch floor: the cluster probe (an empty kernel)
    # at each entry's grid, cluster shape and shared memory, once a
    # direction; its bound is no less.
    for name, c, log_n, ctas in (("K1.rns.cl", c14, 14, 3),
                                 ("K6.rns.cl", c15, 14, 6),
                                 (shard.CLUSTER_NAME, c_shard, 14, 1)):
        chunk = (1 << log_n) // c
        floor_ms = 2 * graph_ms(lambda: launch_empty(
            ctas * c, chunk // 8, c, 8 * chunk), 20)
        entry = next(e for e in entries if e["name"].startswith(name + " "))
        entry["launch_floor_ms"] = floor_ms
        if floor_ms > entry["bound_ms"]:
            entry["bound_ms"], entry["bound_by"] = floor_ms, "launch floor"
        log(f"{name} launch floor (C={c}, {ctas * c} CTAs of {chunk // 8} "
            f"threads, twice) {floor_ms:.4f} ms; bound {entry['bound_ms']:.4f}"
            f" ms ({entry['bound_by']}), {entry['bound_ms'] / entry['ms']:.1%}"
            " of bound")

    # K4's floor: the empty probe with K4's grid at the main path's 2 x 2^12
    # elements (32 CTAs of 128 threads, far under a wave, so that the
    # occupancy does not enter: 8 CTAs an SM stands in for it), in the
    # same graph harness; and K4
    # at 2^22 elements (2 x 16 x 2^17, IMF 4, 60-bit q), where its bound is
    # bytes. PERF.md row 4 takes the larger of the floor and the bytes
    # bound as K4's bound at 2 x 2^12.
    k4_blocks, k4_threads = eltwise_grid(2 * n12, 8 * sms)
    floor_ms = graph_ms(lambda: launch_empty(k4_blocks, k4_threads), 20)
    k4_big_ms = graph_ms(walk["K4"], 20)
    k4_big_bound, k4_big_by = bound(8 * 3 * elems,
                                    elems * per_barrett)
    k4_entry = next(e for e in entries if e["name"].startswith("K4 "))
    k4_entry.update({"launch_floor_ms": floor_ms,
                     "launch_floor_grid": [k4_blocks, k4_threads],
                     "ms_2^22": k4_big_ms, "bound_ms_2^22": k4_big_bound})
    log(f"K4 floor: the empty kernel at K4's grid ({k4_blocks} x "
        f"{k4_threads}) {floor_ms:.4f} ms; K4 at 2 x 2^12 "
        f"{k4_entry['ms']:.4f} ms ({floor_ms / k4_entry['ms']:.1%} of it "
        f"the floor); K4 at 2^22 elements (IMF 4, 60-bit) {k4_big_ms:.4f} "
        f"ms, bound {k4_big_bound:.4f} ms ({k4_big_by}), "
        f"{k4_big_bound / k4_big_ms:.1%} of bound")

    # K5 at every D of the split (N x batch = 2^21) in both words and in
    # each form, with its bound, registers, CTAs per SM and the rule's
    # form (PERF.md row 5).
    k5_rows = k5_table(rng, dev, nt, get_plan, hier, to_tensor, resources,
                       {64: per_shoup, 32: per_shoup32}, bound)
    next(e for e in entries if e["name"].startswith("K5 "))["per_D"] = \
        k5_rows

    rows = json.loads((ROOT / "benchmarks" / "reference_baseline"
                       / "baseline_results.json").read_text())

    def event_ms(fn, reps=20):
        """Median device ms of fn() over `reps` CUDA-event timings, after
        three warm-up calls."""
        times = []
        for i in range(reps + 3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        return statistics.median(times)

    def public_pairs(engine, x, q_bits):
        """fwd+inv pairs/s through the public engine on device tensors,
        beside the Xeon reference's fwd_ntt + inv_ntt rows."""
        batch, n = x.shape
        pair_ms = event_ms(lambda: engine.inverse(engine.forward(x)))
        pairs_per_s = batch / (pair_ms / 1e3)
        xeon_us = sum(r["us_per_call"] for r in rows
                      if r["kernel"] in ("fwd_ntt", "inv_ntt")
                      and r["n"] == n and r["q_bits"] == q_bits)
        xeon_pairs = 1e6 / xeon_us
        log(f"public NTT(2^{n.bit_length() - 1}, {q_bits}-bit) fwd+inv at "
            f"batch {batch}: {pair_ms:.4f} ms per batch = {pairs_per_s:.1f} "
            f"pairs/s; Xeon reference {xeon_pairs:.1f} pairs/s; ratio "
            f"{pairs_per_s / xeon_pairs:.3f}")

    public_pairs(ntt14, rand((256, n14), q60), 60)
    public_pairs(e17, rand((SPLIT_BATCH, n17), q60_17), 60)
    public_pairs(e17s, rand((SPLIT_BATCH, n17), q29_17), 29)
    public_pairs(ntt10s, rand((N10_BATCH, n10), q29), 29)

    # The lean regime against the exact one, the A/B behind
    # config.approx_butterflies' CUDA default: the public fwd+inv pair (OMF
    # 1) at each sixth-path shape, 20 CUDA-event timings per turn, in turns
    # exact, lean, lean, exact (40 each), the regime forced on for the lean
    # turns; the same pair replayed from a CUDA graph (device time); the
    # RNS product both ways. "Beyond the spread": every lean timing below
    # every exact one.
    def event_times(fn, reps=20):
        """`reps` CUDA-event timings (ms) of fn(), after three warm-ups."""
        times = []
        for i in range(reps + 3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        return times

    def regime_ab(fn, reps, inner):
        times = {"exact": [], "lean": []}
        replay = {"exact": [], "lean": []}
        for turn in ("exact", "lean", "lean", "exact"):
            port_config.approx_butterflies = (
                (lambda device: True) if turn == "lean" else exact_regime)
            try:
                times[turn] += event_times(fn, reps)
                replay[turn].append(graph_ms(fn, inner))
            finally:
                port_config.approx_butterflies = exact_regime
        return times, replay

    def spread(v):
        return (f"median {statistics.median(v):.4f} ms [min {min(v):.4f}, "
                f"max {max(v):.4f}]")

    for key, (name, e, x) in sixth.items():
        times, replay = regime_ab(lambda: e.inverse(e.forward(x)), 20, 10)
        batch = x.shape[0]
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"A/B {name}, {key.split()[0]} against exact, fwd+inv pair: "
            f"exact {spread(times['exact'])} = "
            f"{batch / med['exact'] * 1e3:.1f} pairs/s; lean "
            f"{spread(times['lean'])} = {batch / med['lean'] * 1e3:.1f} "
            f"pairs/s; lean/exact {med['lean'] / med['exact']:.4f}; lean "
            f"faster beyond the spread: "
            f"{max(times['lean']) < min(times['exact'])}; replayed from "
            f"graphs: exact {replay['exact']} ms, lean {replay['lean']} ms")
    times, replay = regime_ab(lambda: rns_poly_mult_mod(ra, rb, n17, moduli),
                              10, 2)
    log(f"A/B rns_poly_mult_mod N=2^17 x {RNS_PRIMES} primes of 50 bits, "
        f"lean16 against exact: exact {spread(times['exact'])}, lean "
        f"{spread(times['lean'])}; replayed: exact {replay['exact']} ms, "
        f"lean {replay['lean']} ms")
    # The approx forms against the exact ones, the A/B that decides
    # CUDA_APPROX_DEFAULT: each row's exact and approx calls on the same
    # shape, in turns exact, approx, approx, exact, each turn the median
    # of 20 replays of a CUDA graph; the approx form is faster at a row
    # only if every approx turn is below every exact one.
    faster_everywhere = True
    for name, (shape, exact_fn, approx_fn, inner) in approx_ab.items():
        turns = {"exact": [], "approx": []}
        for turn in ("exact", "approx", "approx", "exact"):
            turns[turn].append(graph_ms(
                exact_fn if turn == "exact" else approx_fn, inner))
        med = {k: statistics.median(v) for k, v in turns.items()}
        faster = max(turns["approx"]) < min(turns["exact"])
        faster_everywhere = faster_everywhere and faster
        entry = next(e for e in entries if e["name"].startswith(name + " "))
        entry["ab_exact_ms"], entry["ab_approx_ms"] = (turns["exact"],
                                                       turns["approx"])
        log(f"A/B {name} at {shape}: exact {turns['exact']} ms, approx "
            f"{turns['approx']} ms (graph medians, turns exact, approx, "
            f"approx, exact); approx/exact {med['approx'] / med['exact']:.4f}"
            f"; approx faster at every turn: {faster}; bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), approx at "
            f"{entry['bound_ms'] / med['approx']:.1%} of it, exact at "
            f"{entry['bound_ms'] / med['exact']:.1%}")
    log(f"A/B approx against exact: approx faster at every row: "
        f"{faster_everywhere}; CUDA_APPROX_DEFAULT = "
        f"{port_config.CUDA_APPROX_DEFAULT}")
    ms_of = {entry["name"].split()[0]: entry["ms"] for entry in entries}
    bflys = chain.ROWS * chain.LANES * chain.REPS
    log(f"K17 chains ({chain.REPS} butterflies on 2 x {chain.ROWS} x "
        f"{chain.LANES}), replayed: lean16 {ms_of['K17']:.4f} ms = "
        f"{bflys / ms_of['K17'] / 1e6:.2f} Gbfly/s, exact "
        f"{ms_of['K17.exact']:.4f} ms = "
        f"{bflys / ms_of['K17.exact'] / 1e6:.2f} Gbfly/s; lean/exact time "
        f"{ms_of['K17'] / ms_of['K17.exact']:.4f}")
    bflys = df_chain.ROWS * df_chain.LANES * df_chain.REPS
    log("K18 chains (" + f"{df_chain.REPS} butterflies on {df_chain.ROWS} x "
        f"{df_chain.LANES}), replayed: " + "; ".join(
            f"{p_} {ms_of[df_chain.kernel_name(p_)]:.4f} ms = "
            f"{bflys / ms_of[df_chain.kernel_name(p_)] / 1e6:.2f} Gbfly/s"
            for p_ in df_chain.PRECISIONS)
        + f"; double-float/f64 time "
        f"{ms_of['K18.df'] / ms_of['K18.f64']:.4f}")

    # The four-step NTT: fwd+inv pairs/s through fwd_ntt_mxu/inv_ntt_mxu
    # against the NTT's (K1 at 2^14, K5/K6 at 2^17) and the Xeon pair, on
    # the same inputs; and where a pass's time goes at 2^14 (the digit
    # split, the int8 product, the fold; the transposes are the rest).
    for n, batch, q, engine in ((n14, 256, q60, ntt14),
                                (n17, SPLIT_BATCH, q60_17, e17)):
        plan = get_mxu_plan(n, q)
        x = rand((batch, n), q)
        mxu_ms = event_ms(lambda: inv_ntt_mxu(fwd_ntt_mxu(x, plan), plan))
        ntt_ms = event_ms(lambda: engine.inverse(engine.forward(x)))
        xeon_us = sum(r["us_per_call"] for r in rows
                      if r["kernel"] in ("fwd_ntt", "inv_ntt")
                      and r["n"] == n and r["q_bits"] == 60)
        log(f"MXU NTT(2^{n.bit_length() - 1}, 60-bit) fwd+inv at batch "
            f"{batch}: {mxu_ms:.4f} ms = {batch / mxu_ms * 1e3:.1f} pairs/s; "
            f"NTT {ntt_ms:.4f} ms = {batch / ntt_ms * 1e3:.1f} pairs/s "
            f"(MXU/NTT time {mxu_ms / ntt_ms:.2f}x); Xeon "
            f"{1e6 / xeon_us:.1f} pairs/s; MXU ratio to Xeon "
            f"{batch / mxu_ms * 1e3 / (1e6 / xeon_us):.3f}")
    split_ms = graph_ms(lambda: mxu_ntt.split_digits(mx, mplan.dx_fwd), 20)
    log(f"MXU pass at N=2^14, batch 256: digit split {split_ms:.4f} ms, "
        f"int8 product {int_mm['ms']:.4f} ms, fold (K14) "
        f"{graph_ms(cases['K14'][4][0], 20):.4f} ms; whole forward "
        f"{graph_ms(lambda: fwd_ntt_mxu(mx.reshape(256, n14), mplan), 5):.4f}"
        " ms (graphs)")

    # The FFT-like at the Xeon rows' shapes (f64, one polynomial, a 2^-30
    # scale fused), per public call against those rows; and CKKS encode
    # and decode per call at the fourth path's shape, per precision.
    for n, x in xeon_in.items():
        e = xeon_fft[n]
        for direction, kernel in (("forward", "fwd_fft_like"),
                                  ("inverse", "inv_fft_like")):
            us = event_ms(lambda: getattr(e, direction)(x), 50) * 1e3
            xeon = next(r["us_per_call"] for r in rows
                        if r["kernel"] == kernel and r["n"] == n)
            log(f"public FFTLike(2^{n.bit_length() - 1}).{direction}, batch "
                f"1: {us:.3f} us per call; Xeon {xeon} us; ratio "
                f"{xeon / us:.3f}")
    for p, e in engines.items():
        words = ckks_words(encoded[p], q_words)
        enc_ms = event_ms(lambda: e.inverse(slots), 10)
        compose_ms = event_ms(lambda: e.build_floating_points_device(
            words, thr_words, q_words, 2.0 ** -FIXED_POINT_BITS), 10)
        if p == "double_float":
            dec_ms = event_ms(lambda: e.df_fwd_body(composed[p],
                                                    e.fused_scale(True)), 10)
        else:
            dec_ms = event_ms(lambda: e.forward(composed[p]), 10)
        log(f"CKKS n=2^14 batch {FFT_BATCH} {p}: encode {enc_ms:.4f} ms, "
            f"decode compose {compose_ms:.4f} ms + forward {dec_ms:.4f} ms "
            "(events, per call)")

    # The 16-prime RNS product: device latency of one call and its launches.
    _build.reset_launches()
    rns_poly_mult_mod(ra, rb, n17, moduli)
    rns_launches = dict(_build.launches)
    rns_ms = event_ms(lambda: rns_poly_mult_mod(ra, rb, n17, moduli), 10)
    rns_graph_ms = graph_ms(lambda: rns_poly_mult_mod(ra, rb, n17, moduli), 2)
    log(f"rns_poly_mult_mod N=2^17 x {RNS_PRIMES} primes of 50 bits: "
        f"{rns_ms:.4f} ms per call (events), {rns_graph_ms:.4f} ms replayed "
        f"from a CUDA graph; {sum(rns_launches.values())} launches per call "
        f"{rns_launches}")

    # The stacked transform against one call a prime (`per_prime_rns`: the
    # parent tree's route, through this tree's single-modulus wrappers) on
    # the same rotating inputs (`rns_runs`, one seed for both), in turns
    # (the loop, stacked, stacked, the loop; 20 graph replays of 10 calls
    # each), with the stacked call's launches, bound and share; KS is the
    # whole key switch (no per-prime form in this tree: `--walk-ab` times
    # the parent's).
    per_prime = per_prime_rns(get_plan, cuda_ntt, poly)
    stacked_runs = rns_runs(np.random.default_rng(SEED), dev, nt, get_plan,
                            cuda_ntt, rns, to_tensor, rns_poly_mult_mod,
                            port.key_switch)
    loop_runs = rns_runs(np.random.default_rng(SEED), dev, nt, get_plan,
                         cuda_ntt, per_prime, to_tensor,
                         per_prime.rns_poly_mult_mod)
    ks_n15, ks_ds14 = KS_SHAPES[-1]
    ks_tf = [(False, ks_ds14), (True, ks_ds14 * (ks_ds14 - 1)),
             (True, ks_ds14), (False, 2), (True, 2 * ks_ds14)]
    stacked_work = {
        "RNS.n14": (2 * (16 * RNS_PRIMES * 16 * n14 + 16 * RNS_PRIMES * n14),
                    ntt_imads(n14, RNS_PRIMES * 16, True)
                    + ntt_imads(n14, RNS_PRIMES * 16, False)),
        "RNS.n17": (2 * (16 * RNS_PRIMES * n17 + 16 * RNS_PRIMES * n17),
                    ntt_imads(n17, RNS_PRIMES, True)
                    + ntt_imads(n17, RNS_PRIMES, False)),
        "RNS.prod": (8 * 3 * RNS_PRIMES * n17 + 8 * 4 * RNS_PRIMES * n17,
                     2 * ntt_imads(n17, RNS_PRIMES, True)
                     + ntt_imads(n17, RNS_PRIMES, False)
                     + RNS_PRIMES * n17 * per_barrett),
        "KS.ntts": (sum(16 * rows * ks_n15 for _, rows in ks_tf)
                    + 8 * 4 * (ks_ds14 + 1) * ks_n15,
                    sum(ntt_imads(ks_n15, rows, fwd) for fwd, rows in ks_tf)),
    }
    stacked_times = {}
    for row, fn in stacked_runs.items():
        turns = {"stacked": [], "loop": []}
        for side in (("loop", "stacked", "stacked", "loop") if row in
                     loop_runs else ("stacked", "stacked")):
            run = fn if side == "stacked" else loop_runs[row]
            turns[side] += graph_times(run, 10, 10)
        _build.reset_launches()
        fn()
        torch.cuda.synchronize()
        per_call = dict(_build.launches)
        ms = statistics.median(turns["stacked"])
        line = (f"stacked {row}: {ms:.4f} ms [{min(turns['stacked']):.4f}, "
                f"{max(turns['stacked']):.4f}]; {sum(per_call.values())} "
                f"launches {per_call}")
        stacked_times[row] = {"ms": ms, "launches": per_call}
        if turns["loop"]:
            loop_ms = statistics.median(turns["loop"])
            line += (f"; one call a prime {loop_ms:.4f} ms "
                     f"[{min(turns['loop']):.4f}, {max(turns['loop']):.4f}],"
                     f" stacked/loop {ms / loop_ms:.3f}")
            stacked_times[row]["loop_ms"] = loop_ms
        if row in stacked_work:
            b_ms, b_by = bound(*stacked_work[row])
            line += f"; bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%}"
        log(line)
    # K5.rns's tiled form (per-row groups of persistent CTAs) beside the
    # single-modulus tiled form on the same bytes: (2^20, batch 16).
    k5t16 = pass_case(n20, q60_20, 16, 64, True)
    t_single = graph_ms(k5t16[0], 20)
    t_rns = next(e["ms"] for e in entries
                 if e["name"].startswith("K5.tile.rns "))
    log(f"K5.tile.rns fwd+inv at (2^20, {RNS_PRIMES} primes, batch 1) "
        f"{t_rns:.4f} ms; the single-modulus K5.tile at (2^20, batch 16) "
        f"{t_single:.4f} ms; ratio {t_rns / t_single:.3f}")
    # The RNS product's routes at N <= 2^14 (`poly.rns_route`): the stacked
    # transforms with K4.rows against K3 once a prime, each forced, on
    # inputs rotating beyond the L2 (median [min, max] of 20 graph replays
    # of 10 calls), at k = 2, 4, 16 primes of 50 bits and batches 1 to 256.
    choose_route = poly.rns_route
    for log_n in (12, 13, 14):
        n = 1 << log_n
        for k in (2, 4, 16):
            basis = nt.generate_primes(k, 50, True, ntt_size=n)
            qs = torch.tensor(basis, dtype=torch.int64,
                              device=dev).view(k, 1, 1)
            for batch in (1, 8, 64, 256):
                sets = max(3, min(16, -(-150_000_000 // (24 * k * batch
                                                         * n))))
                nxt = rotating([tuple(
                    torch.randint(0, 1 << 62, (k, batch, n), device=dev)
                    % qs for _ in range(2)) for _ in range(sets)])
                got = {}
                for route_ in poly.RNS_ROUTES:
                    poly.rns_route = lambda *args, r=route_: r
                    try:
                        got[route_] = graph_times(
                            lambda: rns_poly_mult_mod(*nxt(), n, basis), 10)
                    finally:
                        poly.rns_route = choose_route
                log(f"RNS route N=2^{log_n} k={k} batch={batch}: rule "
                    f"{poly.rns_route(n, k, batch)}; ms " + " ".join(
                        f"{r}={statistics.median(v):.4f} [{min(v):.4f}, "
                        f"{max(v):.4f}]" for r, v in got.items()))

    # The fifth path per call: latency (events, median of 5), the same call
    # replayed from a CUDA graph (its kernels and copies without host gaps),
    # its launches by kernel, its exchange copies and their bytes, and the
    # same work on one device (the single-device entry points) on the same
    # inputs, both ways. Every mesh is one card: the ratios are the virtual
    # mesh's overhead (its copies and its many smaller launches, serialised
    # on one stream), not a scaling figure.
    for name, (call, mesh, single) in fifth.items():
        _build.reset_launches()
        pmesh.reset_exchanges()
        call()
        torch.cuda.synchronize()
        per_call, exch = dict(_build.launches), dict(pmesh.exchanges)
        ms, one_ms = event_ms(call, 5), event_ms(single, 5)
        replay, one_replay = graph_ms(call, 1), graph_ms(single, 1)
        log(f"fifth path {name}: {ms:.4f} ms per call (events), "
            f"{replay:.4f} ms replayed from a CUDA graph, on "
            f"{mesh.distinct_devices()} distinct device(s) for "
            f"{mesh.devices.size} positions; {sum(per_call.values())} "
            f"launches per call {per_call}; {exch.get('copies', 0)} exchange "
            f"copies of {exch.get('bytes', 0)} bytes; one device "
            f"{one_ms:.4f} ms ({one_replay:.4f} replayed); mesh/one-device "
            f"time {ms / one_ms:.2f}x ({replay / one_replay:.2f}x replayed)")

    # The eltwise ops through the public entry points at their Xeon rows'
    # shapes, per call (events, median of 50), against those rows. The
    # Xeon Montgomery rows use R = 2^46 and this port R = 2^64: the same
    # class of work, not the same function.
    def xeon_row(kernel, n, q_bits):
        return next(r["us_per_call"] for r in rows if r["kernel"] == kernel
                    and r["n"] == n and r["q_bits"] == q_bits)

    def vec(n, bound):
        return rand((n,), bound)

    q12 = top_modulus(nt, 60, n12)
    a, b = vec(n12, q12), vec(n12, q12)
    public = [
        ("eltwise_add_mod", n12, 60,
         lambda: port.eltwise_add_mod(a, b, q12)),
        ("eltwise_sub_mod", n12, 60,
         lambda: port.eltwise_sub_mod(a, b, q12)),
        ("eltwise_add_mod_scalar", n12, 60,
         lambda: port.eltwise_add_mod(a, 1234567, q12)),
        ("eltwise_sub_mod_scalar", n12, 60,
         lambda: port.eltwise_sub_mod(a, 1234567, q12))]
    n13 = 1 << 13
    for bits in (49, 60):
        q = top_modulus(nt, bits, n13)
        x, y, z = vec(n13, q), vec(n13, q), vec(n13, 4 * q)
        public += [
            ("eltwise_mult_mod", n13, bits,
             lambda x=x, y=y, q=q: port.eltwise_mult_mod(x, y, q, 1)),
            ("eltwise_reduce_mod", n13, bits,
             lambda z=z, q=q: port.eltwise_reduce_mod(z, q, 4, 1))]
    q59 = top_modulus(nt, 59, n14)
    f1, f3, f2 = vec(n14, q59), vec(n14, q59), vec(n14, 2 * q59)
    public += [
        ("eltwise_fma_mod", n14, 59,
         lambda: port.eltwise_fma_mod(f1, 12345, f3, q59, 1)),
        ("eltwise_fma_mod_no_addend", n14, 59,
         lambda: port.eltwise_fma_mod(f1, 12345, None, q59, 1)),
        ("eltwise_cmp_add", n14, 59,
         lambda: port.eltwise_cmp_add(f1, "nlt", q59 // 2, 42)),
        ("eltwise_cmp_sub_mod", n14, 59,
         lambda: port.eltwise_cmp_sub_mod(f1, q59, "nlt", q59 // 2, 42)),
        ("eltwise_reduce_mod_2to1", n14, 59,
         lambda: port.eltwise_reduce_mod(f2, q59, 2, 1))]
    qm = XEON_MONT_MODULUS
    ma, mb = vec(n13, qm), vec(n13, qm)
    public += [
        ("eltwise_mont_reduce", n13, 47,
         lambda: port.eltwise_montgomery_mult_reduce(ma, mb, qm)),
        ("eltwise_mont_form_in", n13, 47,
         lambda: port.eltwise_montgomery_form_in(ma, qm)),
        ("eltwise_mont_form_out", n13, 47,
         lambda: port.eltwise_montgomery_form_out(ma, qm))]
    q4 = nt.generate_primes(4, 50, True, ntt_size=n14)
    d4 = [torch.stack([vec(n14, q) for q in q4]) for _ in range(4)]
    public.append(("dyadic_multiply", n14, 50, lambda: port.dyadic_multiply(
        torch.stack(d4[:2]), torch.stack(d4[2:]), q4)))
    for kernel, n, bits, fn in public:
        us = event_ms(fn, 50) * 1e3
        xeon = xeon_row(kernel, n, bits)
        log(f"public {kernel} (2^{n.bit_length() - 1}, {bits}-bit): "
            f"{us:.3f} us per call; Xeon {xeon} us; ratio {xeon / us:.3f}")

    # The key switch per call: device latency (events), the same call
    # replayed from a CUDA graph (kernels without host gaps), the NTT
    # launches alone (the same transforms, graph-replayed), and the
    # launches per call, against the Xeon rows where one exists.
    for n, ds in KS_SHAPES:
        result, t, keys, ks_moduli, msf = key_switch_inputs(
            rng, n, (49,) * (ds + 1), 2, dev, nt, to_tensor)
        call = lambda: port.key_switch(result, t, n, ds, ds + 1, ds + 1, 2,
                                       ks_moduli, keys, msf)
        _build.reset_launches()
        call()
        ks_launches = dict(_build.launches)
        ks_ms = event_ms(call, 10)
        with forced_clusters(rns, 1):
            one_cta_ms = event_ms(call, 10)
        ks_graph = graph_ms(call, 1)
        ntt_graph = graph_ms(key_switch_ntts(n, ds, ks_moduli, rand,
                                             get_plan, cuda_ntt, rns), 1)
        name = "key_switch_ds5" if ds == 5 else "key_switch"
        xeon = (f"; Xeon {xeon_row(name, n, 49)} us, ratio "
                f"{xeon_row(name, n, 49) / (ks_ms * 1e3):.3f}"
                if ds in (3, 5) else "; no Xeon row")
        log(f"key_switch N=2^{n.bit_length() - 1} ds={ds} kc=2 49-bit: "
            f"{ks_ms:.4f} ms per call (events), {ks_graph:.4f} ms replayed "
            f"(kernels), of which NTTs {ntt_graph:.4f} ms, other kernels "
            f"{ks_graph - ntt_graph:.4f} ms, host gaps "
            f"{ks_ms - ks_graph:.4f} ms; {sum(ks_launches.values())} "
            f"launches per call {ks_launches}{xeon}; with the cluster "
            f"form's rule kept at C = 1: {one_cta_ms:.4f} ms per call "
            f"(events)")

    # The cluster form at every launch of the key switches: each
    # transform of `key_switch_transforms` at every KS_SHAPES entry (above
    # 2^14 its local pass), through a plan of its rows (the ds stacked
    # decomposition primes, or the key prime alone), in the one-CTA form
    # (K1.rns, K6.rns) and in the rule's C (`rns.cluster_for`), each
    # beside its bound: the larger of its bytes (each coefficient read and
    # written once, its tables once), its IMADs and its launch floor (the
    # cluster probe at the same grid, cluster shape and shared memory).
    ks_cluster = []
    for n, ds in KS_SHAPES:
        log_n = n.bit_length() - 1
        log_l, shards = min(log_n, 14), max(1, n >> 14)
        basis = nt.generate_primes(ds + 1, 49, True, ntt_size=n)
        for label, rows_, batch, forward, imf, omf in \
                key_switch_transforms(ds):
            primes = basis[:ds] if rows_ > 1 else basis[-1:]
            rplan = rns.get_rns_plan(n, primes)
            descs = rplan.descriptors(dev)
            x = torch.stack([rand((batch, n), imf * q) for q in primes])
            ctas = rows_ * batch * shards
            rule = rns.cluster_for(log_l, ctas, sms, dev)
            stages = log_l + (not forward and shards == 1)
            nbytes = 2 * 8 * ctas * (1 << log_l) + 2 * 8 * rows_ * n
            nops = ctas * stages * (1 << (log_l - 1)) * per_shoup
            b_ms, b_by = bound(nbytes, nops)
            row = {"shape": f"N=2^{log_n} ds {ds} {label}", "ctas": ctas,
                   "rule": rule}
            for c in sorted({1, rule}):
                if c > 1:
                    run = lambda c=c: rns._cluster(x, descs, rplan, batch,
                                                   forward, omf, c)
                elif shards == 1:
                    run = lambda: rns._whole(x, descs, rplan, batch, forward,
                                             omf, "exact")
                else:
                    run = lambda: rns._local(x, descs, rplan, batch, forward,
                                             omf, "exact")
                chunk = (1 << log_l) // c
                threads = min(1024, chunk // 8)
                floor_ms = graph_ms(lambda: launch_empty(
                    ctas * c, threads, c, 8 * chunk), 20)
                ms = graph_ms(run, 20)
                c_bound = max(b_ms, floor_ms)
                row[f"C{c}"] = {"ms": ms, "floor_ms": floor_ms,
                                "bound_ms": c_bound,
                                "bound_by": b_by if b_ms >= floor_ms
                                else "launch floor"}
            ks_cluster.append(row)
            log(f"cluster at key switch N=2^{log_n} ds={ds} {label} "
                f"({ctas} one-CTA CTAs, rule C={rule}): " + "; ".join(
                    f"{k} {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
                    f"({v['bound_by']}), {v['bound_ms'] / v['ms']:.1%}"
                    for k, v in row.items() if k.startswith("C")))
    for name in ("K1.rns.cl", "K6.rns.cl"):
        next(e for e in entries if e["name"].startswith(name + " "))[
            "key_switch_launches"] = [
                r for r in ks_cluster
                if (r["shape"].startswith("N=2^14")) == (name == "K1.rns.cl")]

    # Host time per forward call at batch 1, by layer: the public entry
    # point, the wrapper under it, and the bare C entry (ctypes and the
    # launch). 200 calls queue well inside the launch queue, so no call
    # waits on the card.
    x1 = rand((1, n14), q60)
    out1 = torch.empty_like(x1)
    tabs14 = plan14.tables(dev)
    fwd_c = _build.function("ntt", "hexl_ntt_fwd", cuda_ntt._FWD_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    layers = {
        "public NTT.forward": lambda: ntt14.forward(x1),
        "wrapper cuda_ntt.fwd_ntt": lambda: cuda_ntt.fwd_ntt(x1, plan14),
        "C entry hexl_ntt_fwd": lambda: fwd_c(
            x1.data_ptr(), out1.data_ptr(), tabs14["rop"].data_ptr(),
            tabs14["prop"].data_ptr(), q60, 14, 1, 1, 1, 64, 0, stream),
    }
    host = {}
    for name, fn in layers.items():
        fn()
        torch.cuda.synchronize()
        per_call = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            per_call.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        host[name] = statistics.median(per_call)
    log("host us per forward call, batch 1: " + "; ".join(
        f"{k} {v:.2f}" for k, v in host.items()))

    # Polynomials per CTA: the fwd+inv pair (60-bit q) with P forced to
    # each power of two K2 takes (P = 1: K1), at the graft shape (N=2^12,
    # batch 2) and at every N from 2 to 2^12 at batches 512, 4096 and 8192,
    # on inputs rotating beyond the L2; "rule" is the wrapper's choice.
    for n, batch in ((n12, 2), *itertools.product(
            [1 << k for k in range(1, 13)], (512, 4096, 8192))):
        q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
        plan = get_plan(n, q)
        nxt = rotating([rand((batch, n), q) for _ in range(
            max(3, min(16, -(-150_000_000 // (16 * batch * n)))))])
        kernel = lambda: cuda_ntt.inv_ntt(cuda_ntt.fwd_ntt(nxt(), plan),
                                          plan)
        ps = [1 << i for i in range(14) if (1 << i) <= min(
            cuda_ntt.max_polys_per_cta(n), batch)]
        got = {p: forced_ms(cuda_ntt, "polys_per_cta", p, kernel, 10)
               for p in ps}
        rule = cuda_ntt.polys_per_cta(n, batch)
        best = min(got, key=got.get)
        log(f"pack N={n} batch={batch}: rule P={rule}, best P={best}, "
            f"rule/best {got[rule] / got[best]:.3f}; ms "
            + " ".join(f"P{p}={v:.4f}" for p, v in got.items()))

    # K3's forms: the product with each form the wrapper takes forced, at
    # N from 2^9 to 2^14 and batches 2 to 512, on inputs rotating beyond
    # the L2 (median [min, max] of 20 graph replays of 10 calls); "rule" is
    # form_for's pick.
    for log_n in range(9, 15):
        n = 1 << log_n
        q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
        plan = get_plan(n, q)
        for batch in (2, 64, 100, 132, 512):
            nxt = rotating([(rand((batch, n), q), rand((batch, n), q))
                            for _ in range(max(3, min(16, -(
                                -150_000_000 // (24 * batch * n)))))])
            got = {}
            for f in poly.forms_of(n):
                with forced_form(poly, f):
                    got[f] = graph_times(lambda: poly.poly_mult(*nxt(), plan),
                                         10)
            log(f"K3 form N=2^{log_n} batch={batch}: rule "
                f"{poly.form_for(n, batch, sms)}; ms " + " ".join(
                    f"{f}={statistics.median(v):.4f} [{min(v):.4f}, "
                    f"{max(v):.4f}]" for f, v in got.items()))

    # The FFT-like's packing: the forward + inverse pair (scale 2^40) with
    # P transforms per CTA forced to each power of two up to the packing
    # rule's (P = 1: K12's radix walk; P > 1: its stage walk), on both
    # sides of each precision's PACK_BELOW; "rule" is the wrapper's choice.
    for prec in FFT_PRECISIONS:
        for n, batch in ((64, 8192), (128, 8192), (256, 512), (256, 8192),
                         (512, 4096), (n10, N10_BATCH), (n12, 1024)):
            e = FFTLike(n, FFT_SCALAR, precision=prec, device=dev)
            fwd_t, inv_t = e.tables(dev)
            sf, si = e.fused_scale(True), e.fused_scale(False)
            v = fft_value(rng, (batch, n), prec, dev)
            run = (lambda v=v, fwd_t=fwd_t, inv_t=inv_t, sf=sf, si=si,
                   prec=prec: cuda_fft.inverse(
                       cuda_fft.forward(v, fwd_t, sf, prec), inv_t, si,
                       prec))
            most = cuda_fft.stage_walk_packing(n, batch, sms)
            got = {p: forced_ms(cuda_fft, "transforms_per_cta", p, run, 10)
                   for p in (1 << i for i in range(most.bit_length()))}
            rule = cuda_fft.transforms_per_cta(n, batch, prec, sms)
            best = min(got, key=got.get)
            log(f"FFT pack {prec} n={n} batch={batch}: rule P={rule}, best "
                f"P={best}; ms " + " ".join(f"P{p}={t:.4f}"
                                          for p, t in got.items()))

    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == "--k5-times":
        sys.exit(k5_times())
    if len(sys.argv) == 6 and sys.argv[1] == "--k5-times":
        sys.exit(k5_times(pathlib.Path(sys.argv[2]).resolve(),
                          [int(v) for v in sys.argv[3].split(",")],
                          [int(v) for v in sys.argv[4].split(",")],
                          sys.argv[5]))
    if len(sys.argv) == 2 and sys.argv[1] == "--k5-variants":
        sys.exit(k5_variants())
    if len(sys.argv) == 3 and sys.argv[1] == "--walk-times":
        sys.exit(walk_times(pathlib.Path(sys.argv[2]).resolve()))
    if len(sys.argv) == 2 and sys.argv[1] == "--cluster-times":
        sys.exit(cluster_times())
    if len(sys.argv) == 4 and sys.argv[1] == "--cluster-times":
        sys.exit(cluster_times(pathlib.Path(sys.argv[2]).resolve(),
                               [int(v) for v in sys.argv[3].split(",")]))
    if len(sys.argv) == 2 and sys.argv[1] == "--shard-variants":
        sys.exit(shard_variants())
    if len(sys.argv) == 3 and sys.argv[1] == "--shard-variant-times":
        sys.exit(shard_variant_times(pathlib.Path(sys.argv[2]).resolve()))
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--shard-times":
        sys.exit(shard_times(pathlib.Path(sys.argv[2]).resolve()
                             if len(sys.argv) == 3 else ROOT))
    if len(sys.argv) == 3 and sys.argv[1] == "--ks-times":
        sys.exit(ks_times(pathlib.Path(sys.argv[2]).resolve()))
    if len(sys.argv) == 3 and sys.argv[1] == "--walk-ab":
        sys.exit(walk_ab(pathlib.Path(sys.argv[2]).resolve()))
    if len(sys.argv) == 3 and sys.argv[1] == "--stream-times":
        sys.exit(stream_times(pathlib.Path(sys.argv[2]).resolve()))
    if 2 <= len(sys.argv) <= 5 and sys.argv[1] == "--stream-variants":
        sys.exit(stream_variants(
            pathlib.Path(sys.argv[2]).resolve() if len(sys.argv) > 2
            else None, int(sys.argv[3]) if len(sys.argv) > 3 else 1,
            sys.argv[4].split(",") if len(sys.argv) > 4 else None))
    if len(sys.argv) == 5 and sys.argv[1] == "--seventh-child":
        sys.exit(seventh_child(*sys.argv[2:]))
    sys.exit(main())
