"""The device trace of a short window: torch.profiler with CPU and CUDA
activity (the way `hexl_tpu_torch/utils/profiling.py::trace` takes it,
kept here so that the program may change), reduced to the device's busy
time, its kernel time, the operations that took the most of it and the
longest idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

WINDOW = "hebench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")


def profile(fn) -> dict:
    """Run fn() under the profiler inside a span named WINDOW, synchronise,
    and return `summarize` of the trace. Raises if no kernel was recorded."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="hebench-") as d:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return summarize(events)


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 letters."""
    return name.split("(", 1)[0][:120] or name[:120]


def _union(spans):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list) -> dict:
    """busy_s, window_s, kernel_s, device_ops and idle_gaps (each at most
    10 [name, seconds], largest first) of a Chrome trace's events."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not win:
        raise RuntimeError("the trace has no hebench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    if not any(e["cat"] == "kernel" for e in dev):
        raise RuntimeError("the trace holds no kernel event: the profiler "
                           "recorded no device work")
    spans, by_name, kernel_us = [], collections.Counter(), 0.0
    for e in dev:
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        spans.append((s, t))
        by_name[short(e["name"])] += t - s
        if e["cat"] == "kernel":
            kernel_us += t - s
    busy = _union(spans)
    busy_us = sum(e - s for s, e in busy)
    # Idle gaps, each named by the innermost host event running at its
    # middle.
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                   and e.get("name") != WINDOW))
    starts = [h[0] for h in host]
    gaps, edges = collections.Counter(), [w0]
    for s, e in busy:
        edges += [s, e]
    edges.append(w1)
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        name = "Python between traced host ops"
        # The latest-starting host event that still runs at mid is the
        # innermost; look back over the nearest few hundred.
        i = bisect.bisect_right(starts, mid)
        for h in reversed(host[max(0, i - 256):i]):
            if h[1] >= mid:
                name = h[2]
                break
        gaps[name] += e - s
    return {
        "busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
        "kernel_s": kernel_us * 1e-6,
        "device_ops": [[k, v * 1e-6] for k, v in by_name.most_common(10)],
        "idle_gaps": [[k, v * 1e-6] for k, v in gaps.most_common(10)]}
