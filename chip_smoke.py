#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hexl_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py

and, to time the radix walk's rows (K1, K2, K3, K6, K7 and K12) against an
earlier tree of the port unpacked
at PARENT (a `git archive` in a directory .gitignore lists), on the same
card in turns parent, this tree, this tree, parent:

    python3 chip_smoke.py --walk-ab PARENT

Phases, each of which fails the run (non-zero exit) if anything is wrong:
  1. the card: CUDA present; its name and power limit from nvidia-smi;
  2. build: every kernel compiled from csrc/ with nvcc for sm_90a, with
     the compiler's -Xptxas -v report (the run fails if a lean, chain,
     radix-walk, K2 or K3 instantiation of the NTT or the FFT-like
     spills), K3's most active clusters per degree, five
     probe kernels whose SASS gives the IMADs of a 64x64 and of a 32x32
     high and low product and of the lean butterflies' approximate 64x64
     high product, and a kernel with an empty body (K4's launch floor);
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
     61 bits and the largest prime below 2^62; K9 (the dyadic product, one
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
  4. five main paths through the public entry points, each with the
     launch counts set to 0 just before it and read just after it.
     The first: NTT(2^14, 60-bit) forward and inverse at batch 256
     from numpy (K1); the __graft_entry__ pipeline (fwd OMF 4 ->
     eltwise_mult_mod IMF 4 -> inv) at 2^12, 50-bit, batch 2 (K1, K4);
     NTT(2^10, 29-bit) forward and inverse at batch 4096 (the single-word
     K7, as in the JAX engine); NTT(2^10, 49-bit) at batch 4096 (K1);
     NTT(2^6, 49-bit) at batch 8192 (K2); poly_mult_mod at (2^12, 50-bit,
     2) and (2^14, 60-bit, 64) (K3, the cluster form) and at (2^13,
     60-bit, 132) (K3.cta, the one-CTA form).
     The second (N above 2^14 and the single-word regime): NTT(2^17,
     60-bit) and NTT(2^17, 29-bit) forward and inverse at batch 16 (K5/K6,
     then their u32 instantiation); NTT(2^14, 29-bit) at batch 256 (K7);
     NTT(2^20, 60-bit) at batch 2 (K5/K6 with 64 shards);
     rns_poly_mult_mod at N=2^17 x 16 primes of 50 bits (BASELINE.json's
     fifth configuration; K5, K6, K4). Every output is then held bit for
     bit against the plain version on the same inputs, poly_mult_mod at
     N = 64 against a schoolbook product in Python integers, and one
     prime of the RNS product against a NumPy product (exact float FFTs
     of 12-bit limbs).
     The third (the eltwise family and the SEAL-shim composites, see
     third_path): every eltwise op at its Xeon row's shape and at 2^22
     elements (64-bit and single-word), dyadic_multiply at 2^14 x 4 and
     2^17 x 16 primes, lr_mat_vec_mult with 16 weights, key_switch at the
     three Xeon shapes and at N=2^15 x ds 14; every output against the
     plain version, and a key switch at N=64 against Python integers.
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
     dist_dyadic_multiply; every output against the port's single-device
     call and the plain path on the same inputs.
     The sixth (see its comment in main): the approximate-butterfly regime
     forced on: NTT(2^14) at 60 bits (lean8) and 59 bits (lean16) at batch
     256, NTT(2^17, 50-bit) at batch 16 (lean16, K5/K6), NTT(2^10, 49-bit)
     at batch 4096 (lean8, K1), NTT(2^6, 49-bit) at batch 8192 (lean8,
     K2), rns_poly_mult_mod at N=2^17 x 16 primes of
     50 bits; the K17 and K18 chains at the probes' shapes; every output
     against the plain lean path, fully reduced ones against the exact
     outputs, the K18 chains against each other;
  5. timings with CUDA events (median of 20): each kernel and its plain
     version at the main paths' shapes, beside the kernel's bound (the
     radix walk's rows, K1, K2, K3, K3.cta, K6, K6 with a shard base, the
     lean K1/K6, K7 and K12, on inputs that rotate beyond the 50 MB L2; K5
     at N=2^20,
     where a thread holds 64 coefficients; K4 beside the empty kernel at
     its grid, its launch floor, and at 2^22 elements); the
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
     and graph replays), the RNS product both ways, and the chains in
     Gbfly/s.
It then prints one JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}.
"""

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
# product, and the approximate 64x64 high product of the lean butterflies
# (csrc/modarith.cuh mulhi64_approx6, spelt out) compile to: the operation
# term of each kernel's bound. Built here only, not into the port's
# libraries.
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
SASS_KINDS = ("mulhi64", "mullo64", "mulhi32", "mullo32", "mulhi64a6")


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
#include <cuda_runtime.h>
__global__ void empty_probe() {}
extern "C" int launch_empty_probe(int blocks, int threads,
                                  cudaStream_t stream) {
  empty_probe<<<blocks, threads, 0, stream>>>();
  return (int)cudaGetLastError();
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
    """launch(blocks, threads): the empty kernel on the current stream."""
    import ctypes
    import torch
    text, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the empty probe:\n{text}")
    fn = ctypes.CDLL(str(lib)).launch_empty_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(blocks, threads):
        err = fn(blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty probe launch failed: cudaError {err}")
    return launch


def eltwise_grid(count: int, sms: int) -> tuple:
    """(blocks, threads) of an eltwise launch of `count` elements
    (csrc/eltwise.cu launch: 256 threads, at most 8 CTAs a SM)."""
    return min(-(-count // 256), 8 * sms), 256


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


def eltwise_cases(q, size, rng, dev, ops, plain64, plain32, nt, to_tensor):
    """(what, kernel, kernel's output, plain output) for every op of K4/K8
    under modulus q: both words where q < 2^30, the IMF/OMF matrix, the
    vector and scalar forms, every predicate with bounds on both sides of
    2^63 and inputs over the whole u64 range."""
    import numpy as np

    def rand(bound):
        return to_tensor(rng.integers(0, bound - 1, size=size,
                                      dtype=np.uint64, endpoint=True), dev)

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
            f = full.clone()
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
THIRD_PATH_KERNELS = ("K1", "K4", "K5", "K6", "K8.add_sub", "K8.add_sub.u32",
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


def key_switch_ntts(n, ds, moduli, rand, get_plan, cuda_ntt):
    """A function that runs the transforms of one key switch (the same
    calls, shapes and lazy ranges, on random inputs): ds inverses of the
    target, ds + 1 forwards of the base-converted rows, the key prime's
    inverse and the mod-down's ds forwards."""
    plans = [get_plan(n, q) for q in moduli]
    inv_in = [rand((n,), 2 * q) for q in moduli[:ds]]
    fwd_in = [rand((ds - 1 if i < ds else ds, n), q)
              for i, q in enumerate(moduli)]
    last_in = rand((2, n), 2 * moduli[-1])
    md_in = [rand((2, n), 2 * q) for q in moduli[:ds]]

    def run():
        for j in range(ds):
            cuda_ntt.inv_ntt(inv_in[j], plans[j], 2, 1)
        for i in range(ds + 1):
            cuda_ntt.fwd_ntt(fwd_in[i], plans[i], 4, 4)
        cuda_ntt.inv_ntt(last_in, plans[ds], 2, 2)
        for i in range(ds):
            cuda_ntt.fwd_ntt(md_in[i], plans[i], 4, 4)
    return run


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
    2^11 to 2^14, in both words and the lean schemes;
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
                                           ("lean8", 1 << 61)) if q < bound]
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


# The instantiations whose registers are checked: the lean ones (mangled
# names with the scheme argument 1 (lean16) or 2 (lean8) after a u64
# word), the chain kernels K17/K18, every radix walk of K1/K6/K7 (the
# forward in four forms: three u64 schemes, u32; the inverse in eight:
# with the final stage and without, each in the three u64 schemes and
# u32; the u64 forms in seven shapes, the u32 ones in ten, ntt_block.cuh
# with_shape), K2's packed walk (forward and inverse, three schemes, R = 8
# and R = 2), K3's kernels (poly.cu: the cluster form at 2^12-2^14, the
# one-CTA form at R = 2, R = 8 and 2^10-2^13), and K12's radix walk (fft.cu
# fft_radix_fwd_kernel and fft_radix_inv_kernel: six shapes in complex
# double and float, three in double-float, fft_with_shape).
NEW_INSTANTIATION = re.compile(
    r"chain_kernel|kernelIyLi[12]E|radix_(packed_)?(fwd|inv)_kernel|"
    r"poly_(cluster|cta)_kernel")
RADIX_INSTANTIATIONS = (3 + 6) * 7 + (1 + 2) * 10
PACKED_INSTANTIATIONS = 2 * 3 * 2
POLY_INSTANTIATIONS = 3 + 6
FFT_RADIX_INSTANTIATIONS = 2 * (6 + 6 + 3)
# K5's lean passes, the chains, the radix walks, K2, K3.
NEW_INSTANTIATIONS = (2 * 6 * 3 + 2 + 3 + RADIX_INSTANTIATIONS
                      + PACKED_INSTANTIATIONS + POLY_INSTANTIATIONS
                      + FFT_RADIX_INSTANTIATIONS)
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
# (the one-CTA form) and "K3.n12" at (2^12, 50-bit, 2). "torch.fft" is
# torch.fft.fft + ifft of a (64, 2^14) complex128, the nearest library
# call to the f64 pair (another function), timed on both sides as a
# yardstick. WALK_ROWS maps each kernels-line entry timed here to its
# row.
WALK_ROWS = {name: name for name in (
    "K1", "K1.lean8", "K1.lean16", "K6", "K6.u32", "K6.lean16", "K6.shard",
    "K7", "K12.f64", "K12.f32", "K12.df", "K3", "K3.cta")}
WALK_ROWS["K2"] = "K2.n6"


def walk_runs(rng, dev, nt, get_plan, cuda_ntt, hier, shard,
              to_tensor) -> dict:
    """{row: fn} for WALK_ROWS' rows and the A/B's other rows (K7.n13,
    K7.n15, K7.n10, FFT.f64, torch.fft, K2, K3.n10, K3.n12), at the shapes
    of phase 5: the pair (2^14, batch 256; 60-bit q, lean16 at 59 bits, K7
    at 29 bits; K7 also at (2^13, 512), (2^15, 128) and (2^10, 4096); the
    public route at (2^10, 49-bit, 4096), K2 at (2^6, 49-bit, 8192)), the
    local pass of N = 2^17 x 16 (60-bit, 29-bit u32, lean16 at 50 bits),
    position 3 of 8 at bench.py's shape (L = 2^11, batch 256), the
    FFT-like of the fourth path (2^14 x 64, scale 2^40), and poly_mult at
    (2^14, 60-bit, 64), (2^13, 60-bit, 132), (2^10, 60-bit, 64) and
    (2^12, 50-bit, 2). Written against the wrappers' signatures, which the
    parent tree of an A/B (`--walk-ab`) shares."""
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

    return {"K1": pair(q60, "exact"), "K1.lean8": pair(q60, "lean8"),
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
            "K3.n12": product(1 << 12, 50, 2)}


def walk_times(root: pathlib.Path) -> int:
    """`--walk-times ROOT`: build the port at ROOT and print, as one JSON
    line, the device ms of each row of `walk_runs` in 20 graph replays of
    20 calls each."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import hexl_tpu_torch
    if not pathlib.Path(hexl_tpu_torch.__file__).is_relative_to(root):
        raise AssertionError(f"imported {hexl_tpu_torch.__file__}, not the "
                             f"port at {root}")
    from hexl_tpu_torch import _build, nt
    from hexl_tpu_torch.limb import to_tensor
    from hexl_tpu_torch.ntt import cuda_ntt, get_plan, hier, shard
    _build.build_all()
    runs = walk_runs(np.random.default_rng(SEED), torch.device("cuda", 0),
                     nt, get_plan, cuda_ntt, hier, shard, to_tensor)
    print(json.dumps({name: graph_times(fn, 20) for name, fn in runs.items()}))
    return 0


def walk_ab(parent: pathlib.Path) -> int:
    """`--walk-ab PARENT`: the walk rows of the port at PARENT (a `git
    archive` of an earlier commit) against this tree's, on one card, in
    turns parent, this tree, this tree, parent (`walk_times` in a process
    each), with each side's median and spread over its 40 replays."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    card = nvidia_smi("name,power.limit")
    log(card)
    times = {"parent": {}, "new": {}}
    for side, root in (("parent", parent), ("new", ROOT), ("new", ROOT),
                       ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--walk-times",
             str(root.resolve())], capture_output=True, text=True,
            timeout=900)
        if proc.returncode:
            log(proc.stdout[-4000:], proc.stderr[-4000:])
            return 1
        for row, v in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            times[side].setdefault(row, []).extend(v)
    summary = {}
    for row in times["new"]:
        n_ = times["new"][row]
        if row not in times["parent"]:
            summary[row] = {"new": {"median": statistics.median(n_),
                                    "min": min(n_), "max": max(n_)}}
            log(f"A/B {row}: new only {statistics.median(n_):.4f} ms "
                f"[{min(n_):.4f}, {max(n_):.4f}]")
            continue
        p_ = times["parent"][row]
        summary[row] = {side: {"median": statistics.median(v), "min": min(v),
                               "max": max(v)}
                        for side, v in (("parent", p_), ("new", n_))}
        summary[row]["new/parent"] = (statistics.median(n_)
                                      / statistics.median(p_))
        log(f"A/B {row}: parent {statistics.median(p_):.4f} ms "
            f"[{min(p_):.4f}, {max(p_):.4f}], new {statistics.median(n_):.4f}"
            f" ms [{min(n_):.4f}, {max(n_):.4f}], new/parent "
            f"{summary[row]['new/parent']:.3f}")
    log(card)
    log(json.dumps({"walk_ab": summary, "card": card}))
    return 0


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
    from hexl_tpu_torch.ntt import cuda_ntt, get_plan, hier, ntt32, torch_ntt
    from hexl_tpu_torch import poly
    dyadic = importlib.import_module("hexl_tpu_torch.experimental.dyadic")
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    from hexl_tpu_torch import FFTLike
    from hexl_tpu_torch.experimental import cuda_fft, df32
    from hexl_tpu_torch.ntt import (fwd_ntt_mxu, get_mxu_plan, inv_ntt_mxu,
                                    mxu_ntt)
    from hexl_tpu_torch.ntt import shard
    from hexl_tpu_torch.parallel import (DistNTT, PipelineNTT,
                                         dist_dyadic_multiply,
                                         dist_key_switch, dist_rns_poly_mult,
                                         make_mesh, make_pipeline_mesh)
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
    log(f"build: {len(new)} lean, chain, radix-walk, K2 and K3 "
        f"instantiations (registers, stack, spill stores, spill loads): "
        f"{new}")
    spilled = {k: v for k, v in new.items() if v[2] or v[3] or v[2] is None}
    if spilled or len(new) < NEW_INSTANTIATIONS:
        raise AssertionError(f"of {NEW_INSTANTIATIONS} new instantiations "
                             f"{len(new)} reported, spills: {spilled}")
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
                    k5 = hier.kernel_name("K5", word)
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
        tpp = ks.mac_flush(tq, keys, c, ds, kc, ds + 1)
        compare("K10", tpp, ks.mac_flush_plain(tq, keys, c.mac, ds, kc,
                                              ds + 1), f"mac_flush {what}")
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
    # The lean instantiations of K1/K2/K5/K6, and the chains K17 and K18.
    checks += lean_kernel_checks(rng, dev, nt, get_plan, cuda_ntt, hier,
                                 torch_ntt, to_tensor, compare, route)
    checks += chain_kernel_checks(rng, dev, chain, df_chain, compare,
                                  compare_fft)
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
    # 2 x 132 CTAs would outnumber the SMs).
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
    # and BASELINE.json's RNS poly-mult, N=2^17 x 16 primes of 50 bits.
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
    torch.cuda.synchronize()
    launches2 = dict(_build.launches)
    log(f"phase 4: second main path's launches {launches2}")
    # Every call launched its kernels, and nothing else ran: two passes per
    # transform, 7 launches per prime of the RNS product.
    expected = {"K5": 4 + 3 * RNS_PRIMES, "K6": 4 + 3 * RNS_PRIMES,
                "K5.u32": 2, "K6.u32": 2, "K7": 2, "K4": RNS_PRIMES}
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
        compare(hier.kernel_name("K5", word), back,
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
        compare("K5", rc[i], poly.poly_mult_plain(ra[i], rb[i], plan),
                f"main path: rns_poly_mult_mod prime {i}")
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
    missing = [k for k in THIRD_PATH_KERNELS if launches3.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"third main path launched no {missing}")
    for (what, kernel, _, plain), out in zip(third, outs):
        compare(kernel, out, plain(), f"main path: {what}")
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

    # The fifth: the parallel layer on meshes of cuda:0 positions (one card
    # holds every position, as one CPU holds the JAX package's virtual
    # devices in its tests and dry run; this says nothing of NVLink or of
    # scaling). BASELINE.json's north star, the RNS poly-mult at N=2^17 x
    # 16 primes of 50 bits, batch 2 (a polynomial per batch row), on the
    # dry run's (batch 2, coeff 4) mesh (L = 2^15: K5 + K6 per position)
    # and its 16-device (2, 8) mesh (L = 2^14); DistNTT fwd+inv at bench.py's
    # shape (2^14, 60-bit, batch 256) on (1, 8) and (2, 4), on (2, 4) with
    # overlap_slices=2, and on the D = 1 mesh; PipelineNTT at 2^14, 60-bit,
    # 16 microbatches of 16 on an 8-position ring; dist_key_switch at the
    # dry run's shape (2^14, ds 3, kc 2, 49-bit) on (2, 4); and
    # dist_dyadic_multiply on the same moduli.
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

    # name -> (call, mesh, the same computation on one device)
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
                           "K11", "K16") if launches5.get(k, 0) < 1]
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
                     "K6.lean16", "K4", "K17", "K17.exact", "K18.df",
                     "K18.f64", "K18.f32")
    missing = [k for k in sixth_kernels if launches6.get(k, 0) < 1]
    exact_names = [k for k in ("K1", "K2", "K5", "K6") if k in launches6]
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
        compare("K5.lean16", rc6[i], plain,
                f"sixth path: rns_poly_mult_mod prime {i} == the plain lean "
                "path")
    compare("K5.lean16", rc6, rc, "sixth path: rns_poly_mult_mod == the "
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
    def product_case(n, q, batch):
        """poly_mult: a and b read, the product written, the four tables
        read once; two forwards, one inverse and a Barrett product a
        coefficient."""
        plan = get_plan(n, q)
        pa, pb = rand((batch, n), q), rand((batch, n), q)
        return (lambda: poly.poly_mult(pa, pb, plan),
                lambda: poly.poly_mult_plain(pa, pb, plan),
                3 * 8 * batch * n + 4 * 8 * n,
                2 * ntt_imads(n, batch, True) + ntt_imads(n, batch, False)
                + batch * n * per_barrett)

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
    tpp = ks.mac_flush(tq, keys, kcon, ks_ds, 2, rows_)
    xl = rand((2, ks_n), 2 * ks_moduli[-1])
    tntt = torch.stack([rand((2, ks_n), 4 * q) for q in ks_moduli[:ks_ds]])
    out_words = rows_ * 2 * ks_n
    cases["K10"] = (
        "mac_flush_kernel", "hexl_tpu_torch/csrc/key_switch.cu",
        "hexl_tpu/experimental/key_switch.py:172-224 (XLA-fused jnp; no "
        "pallas_call)", f"key-switch MAC + flush, N=2^15, ds {ks_ds}, kc 2",
        (lambda: ks.mac_flush(tq, keys, kcon, ks_ds, 2, rows_),
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
    for name, row in WALK_ROWS.items():
        desc, source, replaces, shape, case = cases[name]
        cases[name] = (desc, source, replaces,
                       f"{shape}, inputs rotating beyond the L2",
                       (walk[row],) + tuple(case[1:]))
    # Entries whose launches are counted under another kernel's name: the
    # fifth path's K6 and K5 launches are all DistNTT positions'.
    counted_as = {"K6.shard": "K6", "K5.col": "K5"}
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
                         sum(counts.get(name, 0) for counts in
                             (launches1, launches2, launches3, launches4,
                              launches5, launches6))),
            "max_abs_err": float(max_err[name]), "matched": True,
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        if near:
            entry["nearest_library"] = near
        entries.append(entry)

    # K4's floor: the empty probe with K4's grid at the main path's 2 x 2^12
    # elements (32 CTAs of 256 threads), in the same graph harness; and K4
    # at 2^22 elements (2 x 16 x 2^17, IMF 4, 60-bit q), where its bound is
    # bytes. PERF.md row 4 takes the larger of the floor and the bytes
    # bound as K4's bound at 2 x 2^12.
    k4_blocks, k4_threads = eltwise_grid(2 * n12, sms)
    floor_ms = graph_ms(lambda: launch_empty(k4_blocks, k4_threads), 20)
    e60x4 = [rand(BIG, 4 * q60b) for _ in range(2)]
    k4_big_ms = graph_ms(lambda: ops.mult_mod(*e60x4, q60b, 4), 20)
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

    # K5 at the largest degree, where a thread holds D = 64 coefficients
    # (128 registers of them at 64 bits; phase 2's -Xptxas -v report gives
    # its registers and stack frame).
    kernel, _, nbytes, nimads = pass_case(n20, q60_20, 2, 64, True)
    ms = graph_ms(kernel, 20)
    bound_ms, bound_by = bound(nbytes, nimads)
    log(f"K5 cross pass fwd + inv, N=2^20 (D=64), 60-bit q, batch 2: "
        f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.1%} of bound")

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
        ks_graph = graph_ms(call, 1)
        ntt_graph = graph_ms(key_switch_ntts(n, ds, ks_moduli, rand,
                                             get_plan, cuda_ntt), 1)
        name = "key_switch_ds5" if ds == 5 else "key_switch"
        xeon = (f"; Xeon {xeon_row(name, n, 49)} us, ratio "
                f"{xeon_row(name, n, 49) / (ks_ms * 1e3):.3f}"
                if ds in (3, 5) else "; no Xeon row")
        log(f"key_switch N=2^{n.bit_length() - 1} ds={ds} kc=2 49-bit: "
            f"{ks_ms:.4f} ms per call (events), {ks_graph:.4f} ms replayed "
            f"(kernels), of which NTTs {ntt_graph:.4f} ms, other kernels "
            f"{ks_graph - ntt_graph:.4f} ms, host gaps "
            f"{ks_ms - ks_graph:.4f} ms; {sum(ks_launches.values())} "
            f"launches per call {ks_launches}{xeon}")

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
    if len(sys.argv) == 3 and sys.argv[1] == "--walk-times":
        sys.exit(walk_times(pathlib.Path(sys.argv[2]).resolve()))
    if len(sys.argv) == 3 and sys.argv[1] == "--walk-ab":
        sys.exit(walk_ab(pathlib.Path(sys.argv[2]).resolve()))
    sys.exit(main())
