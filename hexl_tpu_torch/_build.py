"""Build and load the port's CUDA kernels and its host library.

Each `csrc/*.cu` file is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface, all files at once in parallel, and loaded
with ctypes. The host library `csrc/host.cpp` (number theory and twiddle
tables, bound by `native.py`) is compiled by `g++` into `libhost.so`
(`build_host`). Each build happens at first use, into `build/hexl_tpu_torch/`
beside the package (listed in `.gitignore`), in a directory keyed by a hash
of every source and of the flags, under a file lock so that concurrent
processes build once. A failed build raises; nothing falls back.

Every C entry launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises if that is not 0 and then counts the
launch under the kernel's name in `launches`. The kernel wrappers share
`on_card` (the checks of their operands, and the choice between the kernel
and the plain version), `batch_of` and `launch_on` (the device and stream
around `launch`; while a `utils.profiling.recording()` is open, each call
is recorded as the span `hexl.launch`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

import torch

from .utils import profiling

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "hexl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
MAX_BATCH = (1 << 31) - 1      # the kernels take the batch as a C int

# Launches per kernel name since the last reset; read by chip_smoke.py to
# show that the main path went through the kernels, and by the benchmark
# (`hebench`) for its launches a call.
launches: collections.Counter = collections.Counter()

_libs: dict = {}
_funcs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("hexl_tpu_torch: nvcc not found (PATH, CUDA_HOME or "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> pathlib.Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + GXX_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".cpp"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@contextlib.contextmanager
def _locked(out_dir: pathlib.Path):
    """The build directory's file lock, held across processes."""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def build_all() -> dict:
    """Compile every `csrc/*.cu` (at once, one nvcc each) unless built.

    Returns {"seconds": float, "built": bool, "log": str, "dir": str}; the
    log is the compiler's output, `-Xptxas -v` included (registers, shared
    memory and spills of every kernel)."""
    out_dir = build_dir()
    log_path = out_dir / "build.log"
    t0 = time.perf_counter()
    with _locked(out_dir):
        todo = [s for s in _sources()
                if not (out_dir / f"lib{s.stem}.so").exists()]
        if todo:
            nvcc = nvcc_path()
            procs = []
            for src in todo:
                tmp = out_dir / f"lib{src.stem}.so.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs, failed = [], []
            for src, tmp, proc in procs:
                text, _ = proc.communicate()
                logs.append(f"== {src.name} (rc {proc.returncode})\n{text}")
                if proc.returncode != 0:
                    failed.append(src.name)
                else:
                    tmp.rename(out_dir / f"lib{src.stem}.so")
            log_path.write_text("\n".join(logs))
            if failed:
                raise RuntimeError(
                    f"hexl_tpu_torch: nvcc failed for {failed}:\n"
                    + "\n".join(logs))
    return {"seconds": time.perf_counter() - t0, "built": bool(todo),
            "log": log_path.read_text() if log_path.exists() else "",
            "dir": str(out_dir)}


def build_host() -> pathlib.Path:
    """Compile `csrc/host.cpp` with g++ into `libhost.so` unless built, and
    return the library's path. A missing g++ or a failed compile raises."""
    out_dir = build_dir()
    lib = out_dir / "libhost.so"
    if lib.exists():
        return lib
    with _locked(out_dir):
        if not lib.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("hexl_tpu_torch: g++ not found on PATH; "
                                   "the host library cannot be built")
            src = CSRC / "host.cpp"
            tmp = out_dir / "libhost.so.tmp"
            proc = subprocess.run(
                [gxx, *GXX_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"hexl_tpu_torch: g++ failed for "
                                   f"{src.name}:\n{proc.stdout}")
            tmp.rename(lib)
    return lib


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def kernel_resources(log: str) -> dict:
    """{mangled kernel name: (registers, stack bytes, spill store bytes,
    spill load bytes)} from the `-Xptxas -v` report in a build log (a
    figure the report leaves out is None)."""
    out, name = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = [None] * 4
            continue
        if name is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[name][1:] = [int(v) for v in m.groups()]
        m = _PTXAS_REGS.search(line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def function(lib: str, entry: str, argtypes):
    """The C entry `entry` of `lib{lib}.so`, with argtypes declared and an
    int (cudaError_t) result."""
    key = (lib, entry)
    fn = _funcs.get(key)
    if fn is None:
        fn = getattr(_lib(lib), entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return fn


def launch(kernel: str, fn, *args) -> None:
    """Call the C entry `fn`; raise on a CUDA error, else count the launch
    of `kernel`."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"hexl_tpu_torch: launch of {kernel} failed with cudaError {err}")
    launches[kernel] += 1


def launch_on(device: torch.device, kernel: str, fn, *args) -> None:
    """`launch` on `device`, with its current stream as the C entry's last
    argument; inside the span `hexl.launch` while a recording is open."""
    # One test a launch: with no recording, no span is made or entered.
    if profiling.records is None:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            launch(kernel, fn, *args, stream)
        return
    with profiling.Span(profiling.LAUNCH, annotate=False):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            launch(kernel, fn, *args, stream)


def on_card(*tensors: torch.Tensor) -> bool:
    """The checks every kernel wrapper makes of its operands: contiguous
    int64 tensors of u64 bits on one device. True on a CUDA device: the
    wrapper launches its kernel. False on the CPU: the wrapper runs the
    plain version. Any other device raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64 tensors of u64 bits, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def batch_of(x: torch.Tensor, degree: int) -> int:
    """The number of polynomials of `degree` coefficients in x, which the
    kernels take as a C int."""
    batch = x.numel() // degree
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds {MAX_BATCH} polynomials")
    return batch
