#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hexl_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if anything is wrong:
  1. the card: CUDA present; its name and power limit from nvidia-smi;
  2. build: every kernel compiled from csrc/ with nvcc for sm_90a, with
     the compiler's -Xptxas -v report, and four probe kernels whose SASS
     gives the IMADs of a 64x64 and of a 32x32 high and low product;
  3. every kernel against its plain PyTorch version on the card, bit-exact:
     K1/K2 over N x q x the IMF/OMF matrix x batch, K3, K4; K5 and K6 (the
     cross and local passes of N > 2^14) at N in {2^15, 2^16, 2^17, 2^20}
     for q just above 2^29, 2^50, 2^60 and 2^61 and the largest q below
     2^62, where 4q is just under 2^64 (the 29-bit one in both the u64 and
     the u32 instantiation), over the IMF/OMF matrix and a ragged batch;
     K7 (the single-word NTT) at N in {2^10, 2^14, 2^15};
  4. two main paths through the public entry points, each with the launch
     counts set to 0 just before it and read just after it.
     The first: NTT(2^14, 60-bit) forward and inverse at batch 256
     from numpy (K1); the __graft_entry__ pipeline (fwd OMF 4 ->
     eltwise_mult_mod IMF 4 -> inv) at 2^12, 50-bit, batch 2 (K1, K4);
     NTT(2^10, 29-bit) forward and inverse at batch 4096 (the single-word
     K7, as in the JAX engine); NTT(2^10, 49-bit) at batch 4096 (K2);
     poly_mult_mod at (2^12, 50-bit, 2) and (2^14, 60-bit, 64) (K3).
     The second (N above 2^14 and the single-word regime): NTT(2^17,
     60-bit) and NTT(2^17, 29-bit) forward and inverse at batch 16 (K5/K6,
     then their u32 instantiation); NTT(2^14, 29-bit) at batch 256 (K7);
     NTT(2^20, 60-bit) at batch 2 (K5/K6 with 64 shards);
     rns_poly_mult_mod at N=2^17 x 16 primes of 50 bits (BASELINE.json's
     fifth configuration; K5, K6, K4). Every output is then held bit for
     bit against the plain version on the same inputs, poly_mult_mod at
     N = 64 against a schoolbook product in Python integers, and one
     prime of the RNS product against a NumPy product (exact float FFTs
     of 12-bit limbs);
  5. timings with CUDA events (median of 20): each kernel and its plain
     version at the main paths' shapes, beside the kernel's bound (and
     K5 at N=2^20, where a thread holds 64 coefficients); the
     fwd+inv pairs/s at N=2^14, 60-bit, batch 256, and at N=2^17 for
     60-bit and 29-bit q at batch 16, each against the Xeon reference of
     benchmarks/reference_baseline/baseline_results.json; the latency and
     launch count of the 16-prime RNS product; the public pairs/s of
     NTT(2^10, 29-bit) at batch 4096 (K7) against its Xeon rows; the
     transform pair with
     each number of polynomials per CTA forced, against the wrapper's
     choice.
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
SPLIT_BATCH = 16   # the N=2^17 transforms of the second main path
RNS_PRIMES = 16    # BASELINE.json's RNS poly-mult: N=2^17 x 16 primes


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# One multiply each, never launched: their SASS (cuobjdump) gives the
# 32-bit IMADs that a 64x64 high and low product, and a 32x32 high and low
# product, compile to: the operation term of each kernel's bound. Built
# here only, not into the port's libraries.
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
SASS_KINDS = ("mulhi64", "mullo64", "mulhi32", "mullo32")


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

    from hexl_tpu_torch import (NTT, _build, eltwise_mult_mod, nt,
                                poly_mult_mod, rns_poly_mult_mod)
    from hexl_tpu_torch.eltwise import ops, torch_kernels
    from hexl_tpu_torch.limb import to_numpy, to_tensor
    from hexl_tpu_torch.ntt import cuda_ntt, get_plan, hier, ntt32, torch_ntt
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
    log(f"IMADs per product (SASS): {imads}")

    # -- 3. each kernel against its plain version, bit-exact ----------------
    max_err = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K5.u32", "K6",
                             "K6.u32", "K7"), 0)

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
    # K5 and K6, each on inputs of its pass's range; batch 3 (or 2 at 2^20)
    # is ragged against nothing but exercises several polynomials.
    for n in (1 << 15, 1 << 16, 1 << 17, 1 << 20):
        for q_bits in (29, 50, 60, 61, 62):
            # generate_primes gives q in (2^b, 2^(b+1)); "62" is the
            # largest prime below 2^62 instead.
            q = (nt.generate_primes(1, 61, False, ntt_size=n)[0]
                 if q_bits == 62 else
                 nt.generate_primes(1, q_bits, True, ntt_size=n)[0])
            plan = get_plan(n, q)
            for batch in ((1, 2) if n == 1 << 20 else (1, 3)):
                for word in ((64, 32) if q_bits < 30 else (64,)):
                    k5 = hier.kernel_name("K5", word)
                    k6 = hier.kernel_name("K6", word)
                    what = f"n={n} q_bits={q_bits} batch={batch} word={word}"
                    for imf in (1, 2, 4):
                        x = rand((batch, n), imf * q)
                        c = hier.cross(x, plan, True, 1, word)
                        compare(k5, c, hier.cross_fwd_plain(x, plan, word),
                                f"cross fwd {what} imf={imf}")
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
                        for omf in (1, 2):
                            compare(k5, hier.cross(loc, plan, False, omf,
                                                   word),
                                    hier.cross_inv_plain(loc, plan, omf, word),
                                    f"cross inv {what} imf={imf} omf={omf}")
                        checks += 3
    # K7, the single-word NTT, against the plain single-word walk.
    for n in (1 << 10, 1 << 14, 1 << 15):
        for q_bits in (20, 29):
            q = nt.generate_primes(1, q_bits, True, ntt_size=n)[0]
            plan = get_plan(n, q)
            for batch in (1, 3, 256):
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
    log(f"phase 3: {checks} kernel-vs-plain checks bit-exact in "
        f"{time.perf_counter() - t0:.1f} s; max_abs_err {max_err}")

    # -- 4. the main paths through the public entry points ------------------
    # The first: bench.py's transform pair (2^14, 60-bit, batch 256); the
    # __graft_entry__ pipeline (2^12, 50-bit, batch 2); the repo's 29-bit
    # Xeon row, NTT(2^10), at a batch that fills the card (a q < 2^30 there
    # takes the single-word K7, as in the JAX engine), and the same
    # transform at 49 bits (the packed route K2); poly_mult_mod at (2^12,
    # 50-bit, 2) and (2^14, 60-bit, 64).
    n14, n12, n10 = 1 << 14, 1 << 12, 1 << 10
    q60 = nt.generate_primes(1, 60, True, ntt_size=n14)[0]
    q50 = nt.generate_primes(1, 50, True, ntt_size=n12)[0]
    q49 = nt.generate_primes(1, 49, True, ntt_size=n10)[0]
    q29 = nt.generate_primes(1, 29, True, ntt_size=n10)[0]
    x14 = rng.integers(0, q60, size=(256, n14), dtype=np.uint64)
    a12, b12 = (rng.integers(0, q50, size=(2, n12), dtype=np.uint64)
                for _ in range(2))
    x10 = rng.integers(0, q49, size=(K2_BATCH, n10), dtype=np.uint64)
    x10s = rng.integers(0, q29, size=(K2_BATCH, n10), dtype=np.uint64)
    a14, b14 = (rng.integers(0, q60, size=(64, n14), dtype=np.uint64)
                for _ in range(2))
    ta12, tb12 = to_tensor(a12, dev), to_tensor(b12, dev)
    ntt14, ntt12, ntt10 = NTT(n14, q60), NTT(n12, q50), NTT(n10, q49)
    ntt10s = NTT(n10, q29)
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
    c12 = poly_mult_mod(a12, b12, n12, q50)
    c14 = poly_mult_mod(a14, b14, n14, q60)
    torch.cuda.synchronize()
    launches1 = dict(_build.launches)
    log(f"phase 4: first main path's launches {launches1}; routes: "
        f"(2^14, 256) {route(n14, 256)}, (2^12, 2) {route(n12, 2)}, "
        f"(2^10, {K2_BATCH}) {route(n10, K2_BATCH)} with "
        f"P={cuda_ntt.polys_per_cta(n10, K2_BATCH, sms)} on {sms} SMs")
    missing = [k for k in ("K1", "K2", "K3", "K4", "K7")
               if launches1.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"first main path launched no {missing}")

    # Every main-path output against the plain version on the same inputs.
    plan14, plan12, plan10 = (get_plan(n14, q60), get_plan(n12, q50),
                              get_plan(n10, q49))
    plan10s = get_plan(n10, q29)
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
            f"main path: NTT(2^10, 29-bit).forward, batch {K2_BATCH}")
    compare("K7", t(back10s), ntt32.inv_ntt32(t(y10s), plan10s),
            f"main path: NTT(2^10, 29-bit).inverse, batch {K2_BATCH}")
    compare(route(n10, K2_BATCH), t(y10), torch_ntt.fwd_ntt(t(x10), plan10),
            f"main path: NTT(2^10, 49-bit).forward, batch {K2_BATCH}")
    compare(route(n10, K2_BATCH), t(back10),
            torch_ntt.inv_ntt(t(y10), plan10),
            f"main path: NTT(2^10, 49-bit).inverse, batch {K2_BATCH}")
    for c, a, b, plan in ((c12, a12, b12, plan12), (c14, a14, b14, plan14)):
        compare("K3", t(c), poly.poly_mult_plain(t(a), t(b), plan),
                f"main path: poly_mult_mod n={plan.n}")
    if not (np.array_equal(back14, x14) and np.array_equal(back10, x10)
            and np.array_equal(back10s, x10s)):
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
    per_shoup32 = imads["mulhi32"] + 2 * imads["mullo32"]
    per_barrett = 2 * imads["mulhi64"] + 2 * imads["mullo64"]

    def ntt_imads(n, batch, forward, shoup=per_shoup):
        log_n = n.bit_length() - 1
        stages = log_n if forward else log_n + 1   # final stage: 2 Shoups
        return batch * stages * (n // 2) * shoup

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
    k2 = pair_case(n10, q49, K2_BATCH, 1)
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

    def pass_case(n, q, batch, word, cross):
        """One pass of the split, forward on inputs in [0, q) and inverse
        on inputs in [0, 2q) (two launches per call). Bytes: each
        coefficient read and written once per direction, plus the twiddle
        entries the pass reads (D - 1 forward, D - 2 inverse for K5; the
        N - D of its stages and their preconditions for K6). Operations:
        one Shoup per butterfly, two in the inverse's final stage (K5)."""
        plan = get_plan(n, q)
        xf, xi = rand((batch, n), q), rand((batch, n), 2 * q)
        log_d = (n // hier.LOCAL_N).bit_length() - 1
        d = 1 << log_d
        shoup = per_shoup32 if word == 32 else per_shoup
        butterflies = batch * (n // 2)
        if cross:
            run, fwd_plain = hier.cross, hier.cross_fwd_plain
            plain = lambda: (fwd_plain(xf, plan, word),
                             hier.cross_inv_plain(xi, plan, 1, word))
            tables = 2 * 8 * (2 * d - 3)
            nimads = (2 * log_d + 1) * butterflies * shoup
        else:
            run, fwd_plain = hier.local, hier.local_fwd_plain
            plain = lambda: (fwd_plain(xf, plan, 1, word),
                             hier.local_inv_plain(xi, plan, word))
            tables = 2 * 2 * 8 * (n - d)
            nimads = 2 * 14 * butterflies * shoup
        kernel = lambda: (run(xf, plan, True, 1, word),
                          run(xi, plan, False, 1, word))
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

    p10 = cuda_ntt.polys_per_cta(n10, K2_BATCH, sms)
    cases = {
        "K1": ("ntt_fwd_kernel+ntt_inv_kernel, 1 poly/CTA",
               "hexl_tpu_torch/csrc/ntt.cu", "hexl_tpu/ntt/pallas_ntt.py:547",
               "fwd OMF1 + inv OMF1 pair, N=2^14, 60-bit q, batch 256", k1),
        "K2": ("ntt_fwd_kernel+ntt_inv_kernel, P polys/CTA",
               "hexl_tpu_torch/csrc/ntt.cu", "hexl_tpu/ntt/pallas_ntt.py:230",
               f"fwd OMF1 + inv OMF1 pair, N=2^10, 49-bit q, batch "
               f"{K2_BATCH} (P={p10})", k2),
        "K3": ("poly_mult_kernel", "hexl_tpu_torch/csrc/poly.cu",
               "hexl_tpu/poly.py:72",
               "poly_mult N=2^14, 60-bit q, batch 64", k3),
        "K4": ("mult_mod_kernel", "hexl_tpu_torch/csrc/eltwise.cu",
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
        "K6": ("ntt_fwd_kernel+ntt_inv_kernel<u64>, 1 shard/CTA",
               "hexl_tpu_torch/csrc/ntt_hier.cu", "hexl_tpu/ntt/hier.py:255",
               f"local pass fwd + inv, N=2^17 (8 shards), 60-bit q, batch "
               f"{SPLIT_BATCH}", k6),
        "K6.u32": ("ntt_fwd_kernel+ntt_inv_kernel<u32>, 1 shard/CTA",
                   "hexl_tpu_torch/csrc/ntt_hier.cu",
                   "hexl_tpu/ntt/hier.py:255",
                   f"local pass fwd + inv, N=2^17 (8 shards), 29-bit q, "
                   f"batch {SPLIT_BATCH}", k6s),
        "K7": ("ntt_fwd_kernel+ntt_inv_kernel<u32>, 1 poly/CTA",
               "hexl_tpu_torch/csrc/ntt.cu", "hexl_tpu/ntt/ntt32.py:205",
               "fwd OMF1 + inv OMF1 pair, N=2^14, 29-bit q, batch 256", k7),
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
            "replaces": replaces,
            "launches": launches1.get(name, 0) + launches2.get(name, 0),
            "max_abs_err": float(max_err[name]), "matched": True,
            "shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})

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
    public_pairs(ntt10s, rand((K2_BATCH, n10), q29), 29)

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
            tabs14["prop"].data_ptr(), q60, 14, 1, 1, 1, 64, stream),
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
