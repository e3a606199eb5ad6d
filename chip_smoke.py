#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hexl_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if anything is wrong:
  1. the card: CUDA present; its name and power limit from nvidia-smi;
  2. build: every kernel compiled from csrc/ with nvcc for sm_90a, with
     the compiler's -Xptxas -v report, and two probe kernels whose SASS
     gives the IMADs of a 64x64 product;
  3. every kernel against its plain PyTorch version on the card, bit-exact
     (K1/K2 over N x q x the IMF/OMF matrix x batch, K3, K4);
  4. the main path through the public entry points with the launch counts
     set to 0 just before and read just after: NTT(2^14, 60-bit) forward
     and inverse at batch 256 from numpy (K1); the __graft_entry__
     pipeline (fwd OMF 4 -> eltwise_mult_mod IMF 4 -> inv) at 2^12,
     50-bit, batch 2 (K1, K4); NTT(2^10, 29-bit) forward and inverse at
     batch 4096 (K2); poly_mult_mod at (2^12, 50-bit, 2) and (2^14,
     60-bit, 64) (K3). Every output is then held bit for bit against the
     plain version on the same inputs, and poly_mult_mod at N = 64 against
     a schoolbook product in Python integers;
  5. timings with CUDA events (median of 20): each kernel and its plain
     version at the main path's shapes, beside the kernel's bound; the
     fwd+inv pairs/s at N=2^14, 60-bit, batch 256 and its ratio to the
     Xeon reference of benchmarks/reference_baseline/baseline_results.json;
     the transform pair with each number of polynomials per CTA forced,
     against the wrapper's choice.
It then prints one JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}.
"""

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
K2_BATCH = 4096    # the N=2^10 transforms of the main path's packed route


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# One 64x64 multiply each, never launched: their SASS (cuobjdump) gives the
# 32-bit IMADs that a high and a low product compile to, the operation term
# of each kernel's bound. Built here only, not into the port's libraries.
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
"""


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
    """32-bit IMADs that one 64x64 high and one low product compile to. An
    IMAD.WIDE (a 32x32 -> 64 product) counts as two; moves, shifts and adds
    that the compiler spells IMAD do not count."""
    text, _ = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the SASS probes:\n{text}")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts = {}
    for kind in ("mulhi64", "mullo64"):
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

    from hexl_tpu_torch import NTT, _build, eltwise_mult_mod, nt, poly_mult_mod
    from hexl_tpu_torch.eltwise import ops, torch_kernels
    from hexl_tpu_torch.limb import to_numpy, to_tensor
    from hexl_tpu_torch.ntt import cuda_ntt, get_plan, torch_ntt
    from hexl_tpu_torch import poly

    dev = torch.device("cuda", 0)
    sms = cuda_ntt.sm_count(dev)
    rng = np.random.default_rng(SEED)

    def rand(shape, bound):
        return to_tensor(rng.integers(0, bound, size=shape, dtype=np.uint64),
                         dev)

    def route(n, batch):
        return "K2" if cuda_ntt.polys_per_cta(n, batch, sms) > 1 else "K1"

    # -- 2. build -----------------------------------------------------------
    probes = start_sass_probes(_build.nvcc_path(),
                               _build.BUILD_ROOT / "sass_probes")
    info = _build.build_all()
    log(f"build: {info['seconds']:.1f} s (built={info['built']}) "
        f"in {info['dir']}")
    log(info["log"])
    imads = sass_imads(*probes)
    log(f"IMADs per 64x64 product (SASS): {imads}")

    # -- 3. each kernel against its plain version, bit-exact ----------------
    max_err = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def compare(kernel, got, want, what):
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item()) if got.numel() else 0
        max_err[kernel] = max(max_err[kernel], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at {what}")

    t0 = time.perf_counter()
    checks = 0
    # Batches 1, 3 and 32 run one polynomial per CTA (K1); 401 packs P > 1
    # per CTA wherever N <= 2^12 (K2), with a ragged last CTA.
    for n in (2, 16, 1024, 4096, 16384):
        for q_bits in (30, 50, 60, 61):
            q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
            plan = get_plan(n, q)
            for batch in (1, 3, 32, 401):
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
    for n, q_bits, batch in ((1 << 12, 50, 2), (1 << 14, 60, 64)):
        q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
        plan = get_plan(n, q)
        a, b = rand((batch, n), q), rand((batch, n), q)
        compare("K3", poly.poly_mult(a, b, plan),
                poly.poly_mult_plain(a, b, plan),
                f"poly_mult n={n} q_bits={q_bits} batch={batch}")
        checks += 1
    for q_bits in (30, 50, 60, 61):
        q = nt.generate_primes(1, q_bits, True, ntt_size=1 << 10)[0]
        for imf in (1, 2, 4):
            a, b = rand((1 << 20,), imf * q), rand((1 << 20,), imf * q)
            compare("K4", ops.mult_mod(a, b, q, imf),
                    torch_kernels.mult_mod(a, b, q, imf),
                    f"mult_mod q_bits={q_bits} imf={imf}")
            checks += 1
    log(f"phase 3: {checks} kernel-vs-plain checks bit-exact in "
        f"{time.perf_counter() - t0:.1f} s; max_abs_err {max_err}")

    # -- 4. the main path through the public entry points -------------------
    # bench.py's transform pair (2^14, 60-bit, batch 256); the
    # __graft_entry__ pipeline (2^12, 50-bit, batch 2); the repo's N=2^10,
    # 29-bit transform at a batch that fills the card (the packed route);
    # poly_mult_mod at (2^12, 50-bit, 2) and (2^14, 60-bit, 64).
    n14, n12, n10 = 1 << 14, 1 << 12, 1 << 10
    q60 = nt.generate_primes(1, 60, True, ntt_size=n14)[0]
    q50 = nt.generate_primes(1, 50, True, ntt_size=n12)[0]
    q29 = nt.generate_primes(1, 29, True, ntt_size=n10)[0]
    x14 = rng.integers(0, q60, size=(256, n14), dtype=np.uint64)
    a12, b12 = (rng.integers(0, q50, size=(2, n12), dtype=np.uint64)
                for _ in range(2))
    x10 = rng.integers(0, q29, size=(K2_BATCH, n10), dtype=np.uint64)
    a14, b14 = (rng.integers(0, q60, size=(64, n14), dtype=np.uint64)
                for _ in range(2))
    ta12, tb12 = to_tensor(a12, dev), to_tensor(b12, dev)
    ntt14, ntt12, ntt10 = NTT(n14, q60), NTT(n12, q50), NTT(n10, q29)
    torch.cuda.synchronize()

    _build.reset_launches()
    y14 = ntt14.forward(x14)
    back14 = ntt14.inverse(y14)
    fa = ntt12.forward(ta12, 1, 4)
    fb = ntt12.forward(tb12, 1, 4)
    prod = eltwise_mult_mod(fa, fb, q50, 4)
    step = ntt12.inverse(prod, 1, 1)
    y10 = ntt10.forward(x10)
    back10 = ntt10.inverse(y10)
    c12 = poly_mult_mod(a12, b12, n12, q50)
    c14 = poly_mult_mod(a14, b14, n14, q60)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    log(f"phase 4: main-path launches {launches}; routes: "
        f"(2^14, 256) {route(n14, 256)}, (2^12, 2) {route(n12, 2)}, "
        f"(2^10, {K2_BATCH}) {route(n10, K2_BATCH)} with "
        f"P={cuda_ntt.polys_per_cta(n10, K2_BATCH, sms)} on {sms} SMs")
    missing = [k for k in ("K1", "K2", "K3", "K4") if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    # Every main-path output against the plain version on the same inputs.
    plan14, plan12, plan10 = (get_plan(n14, q60), get_plan(n12, q50),
                              get_plan(n10, q29))
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
    compare(route(n10, K2_BATCH), t(y10), torch_ntt.fwd_ntt(t(x10), plan10),
            f"main path: NTT(2^10, 29-bit).forward, batch {K2_BATCH}")
    compare(route(n10, K2_BATCH), t(back10),
            torch_ntt.inv_ntt(t(y10), plan10),
            f"main path: NTT(2^10, 29-bit).inverse, batch {K2_BATCH}")
    for c, a, b, plan in ((c12, a12, b12, plan12), (c14, a14, b14, plan14)):
        compare("K3", t(c), poly.poly_mult_plain(t(a), t(b), plan),
                f"main path: poly_mult_mod n={plan.n}")
    if not (np.array_equal(back14, x14) and np.array_equal(back10, x10)):
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
    log("phase 4: every main-path output == its plain version; round trips "
        "exact; pipeline == poly_mult_mod; n=64 == schoolbook")

    # -- 5. timings ---------------------------------------------------------
    def graph_ms(fn, inner):
        """Median device ms of one call of fn over 20 replays of a CUDA
        graph holding `inner` calls (no host gaps between launches)."""
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
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        del graph
        return statistics.median(times)

    def forced_ms(p, fn, inner):
        """graph_ms with P polynomials per CTA instead of the rule's."""
        choose = cuda_ntt.polys_per_cta
        cuda_ntt.polys_per_cta = lambda degree, batch, sms: min(p, batch)
        try:
            return graph_ms(fn, inner)
        finally:
            cuda_ntt.polys_per_cta = choose

    imad_rate = SMS * INT32_LANES_PER_SM * sm_mhz * 1e6
    per_shoup = imads["mulhi64"] + 2 * imads["mullo64"]
    per_barrett = 2 * imads["mulhi64"] + 2 * imads["mullo64"]

    def ntt_imads(n, batch, forward):
        log_n = n.bit_length() - 1
        stages = log_n if forward else log_n + 1   # final stage: 2 Shoups
        return batch * stages * (n // 2) * per_shoup

    def bound(nbytes, nimads):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nimads / imad_rate * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    def pair_case(n, q, batch, omf_fwd):
        plan = get_plan(n, q)
        x = rand((batch, n), q)
        kernel = lambda: cuda_ntt.inv_ntt(
            cuda_ntt.fwd_ntt(x, plan, 1, omf_fwd), plan, 1, 1)
        plain = lambda: torch_ntt.inv_ntt(
            torch_ntt.fwd_ntt(x, plan, 1, omf_fwd), plan, 1, 1)
        nbytes = 2 * (2 * 8 * batch * n + 2 * 8 * n)
        nimads = ntt_imads(n, batch, True) + ntt_imads(n, batch, False)
        return kernel, plain, nbytes, nimads

    k1 = pair_case(n14, q60, 256, 1)
    k2 = pair_case(n10, q29, K2_BATCH, 1)
    pa, pb = rand((64, n14), q60), rand((64, n14), q60)
    k3 = (lambda: poly.poly_mult(pa, pb, plan14),
          lambda: poly.poly_mult_plain(pa, pb, plan14),
          3 * 8 * 64 * n14 + 4 * 8 * n14,
          2 * ntt_imads(n14, 64, True) + ntt_imads(n14, 64, False)
          + 64 * n14 * per_barrett)
    ea, eb = rand((2, n12), 4 * q50), rand((2, n12), 4 * q50)
    k4 = (lambda: ops.mult_mod(ea, eb, q50, 4),
          lambda: torch_kernels.mult_mod(ea, eb, q50, 4),
          3 * 8 * 2 * n12, 2 * n12 * per_barrett)

    p10 = cuda_ntt.polys_per_cta(n10, K2_BATCH, sms)
    cases = {
        "K1": ("ntt_fwd_kernel+ntt_inv_kernel, 1 poly/CTA",
               "hexl_tpu_torch/csrc/ntt.cu", "hexl_tpu/ntt/pallas_ntt.py:547",
               "fwd OMF1 + inv OMF1 pair, N=2^14, 60-bit q, batch 256", k1),
        "K2": ("ntt_fwd_kernel+ntt_inv_kernel, P polys/CTA",
               "hexl_tpu_torch/csrc/ntt.cu", "hexl_tpu/ntt/pallas_ntt.py:230",
               f"fwd OMF1 + inv OMF1 pair, N=2^10, 29-bit q, batch "
               f"{K2_BATCH} (P={p10})", k2),
        "K3": ("poly_mult_kernel", "hexl_tpu_torch/csrc/poly.cu",
               "hexl_tpu/poly.py:72",
               "poly_mult N=2^14, 60-bit q, batch 64", k3),
        "K4": ("mult_mod_kernel", "hexl_tpu_torch/csrc/eltwise.cu",
               "hexl_tpu/eltwise/pallas_kernels.py:65",
               "mult_mod IMF 4, 2x2^12 elements, 50-bit q", k4),
    }
    entries = []
    for name, (desc, source, replaces, shape, case) in cases.items():
        kernel, plain, nbytes, nimads = case
        ms = graph_ms(kernel, 20)
        plain_ms = graph_ms(plain, 2)
        bound_ms, bound_by = bound(nbytes, nimads)
        log(f"{name} {desc} at {shape}: {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, "
            f"{nimads} IMADs), {bound_ms / ms:.1%} of bound")
        entries.append({
            "name": f"{name} {desc}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": float(max_err[name]), "matched": True,
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

    xt = rand((256, n14), q60)
    times = []
    for i in range(23):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ntt14.inverse(ntt14.forward(xt))
        end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    pair_ms = statistics.median(times)
    pairs_per_s = 256 / (pair_ms / 1e3)
    rows = json.loads((ROOT / "benchmarks" / "reference_baseline"
                       / "baseline_results.json").read_text())
    xeon_us = sum(r["us_per_call"] for r in rows
                  if r["kernel"] in ("fwd_ntt", "inv_ntt")
                  and r["n"] == n14 and r["q_bits"] == 60)
    xeon_pairs = 1e6 / xeon_us
    log(f"public NTT(2^14, 60-bit) fwd+inv at batch 256: {pair_ms:.4f} ms "
        f"per batch = {pairs_per_s:.1f} pairs/s; Xeon reference "
        f"{xeon_pairs:.1f} pairs/s; ratio {pairs_per_s / xeon_pairs:.3f}")

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
            tabs14["prop"].data_ptr(), q60, 14, 1, 1, 1, stream),
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
    # each power of two up to 2^13/N, at the graft shape (N=2^12, batch 2)
    # and at batches that fill the card; "rule" is the wrapper's choice.
    for n, batch in ((n12, 2), (16, 512), (16, 8192), (64, 512), (64, 8192),
                     (256, 512), (256, 8192), (n10, 512), (n10, K2_BATCH),
                     (n10, 8192), (n12, 512), (n12, 8192)):
        q = nt.generate_primes(1, 60, True, ntt_size=n)[0]
        kernel = pair_case(n, q, batch, 1)[0]
        ps = [1 << i for i in range(14) if (1 << i) <= min(
            cuda_ntt.PACK_COEFFS // n, batch)]
        got = {p: forced_ms(p, kernel, 10) for p in ps}
        rule = cuda_ntt.polys_per_cta(n, batch, sms)
        best = min(got, key=got.get)
        log(f"pack N={n} batch={batch}: rule P={rule}, best P={best}; ms "
            + " ".join(f"P{p}={v:.4f}" for p, v in got.items()))

    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
