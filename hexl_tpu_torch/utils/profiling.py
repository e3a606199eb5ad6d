"""Profiling helpers: the port's counterpart of `hexl_tpu/utils/profiling.py`.

  * trace(log_dir): a context manager around `torch.profiler.profile` that
    records the host (CPU activity) and, where a card is present, the
    device (CUDA activity), and writes a Chrome-trace JSON into `log_dir`.
  * ntt_cost(n, q_bits, approx_mulhi): the JAX package's analytic op and
    byte counts of one forward transform, copied unchanged.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile what runs inside the block into a Chrome trace in `log_dir`.

    Yields the path of the JSON file, which is written when the block
    ends. With a card present the trace also records CUDA activity (the
    kernels, whether launched by PyTorch or through the port's C entries)
    after synchronising the device; if it then holds no kernel event the
    device was not traced, and this raises rather than hand back a trace of
    the host alone."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"hexl_tpu_torch.{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if cuda:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(e.get("cat") == "kernel" for e in events):
            raise RuntimeError(
                f"hexl_tpu_torch: the trace {path} asked for CUDA activity "
                "but holds no kernel event (CUPTI recorded no device work)")


def ntt_cost(n: int, q_bits: int = 60, approx_mulhi: bool = True) -> dict:
    """The JAX package's analytic cost model of one forward transform on
    its TPU limb kernels (2x32-bit limbs, native 32-bit vector multiplies),
    returned unchanged: butterflies, 32-bit multiplies and the HBM bytes of
    its fused and its staged kernels.

    It is not a cost model of the port's Hopper kernels, whose bounds
    `chip_smoke.py` computes from their own IMAD counts and bytes."""
    butterflies = (n // 2) * int(math.log2(n))
    if q_bits < 30:
        # single-limb path: shoup mulhi32 (4) + 2 mullo (2)
        muls_per_bfly = 6
    else:
        # 2-limb: approx mulhi64 (12) or exact (16), + 2 mullo64 (6 each)
        muls_per_bfly = (12 if approx_mulhi else 16) + 12
    planes = 1 if q_bits < 30 else 2
    return {
        "butterflies": butterflies,
        "mul32_total": butterflies * muls_per_bfly,
        "hbm_bytes_fused": 2 * n * 4 * planes,   # read + write once
        "hbm_bytes_staged": 2 * n * 4 * planes * int(math.log2(n)),
    }
