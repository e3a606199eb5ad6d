"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the result's line.

A cell's traffic file names the operation (`ops/<op>.py`), the calls kept
in flight, the pool of inputs, how many calls' outputs the check samples
and how many calls the traced window holds. The loop is closed: the host
issues the next call without waiting until `in_flight` calls are
outstanding, then waits on the CUDA event of the oldest; with one in
flight it synchronises each call and times it from its issue to its
result being ready.
"""

from __future__ import annotations

import collections
import contextlib
import random
import sys
import time
from types import SimpleNamespace

import torch

from hebench import roofline, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "hexl_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class Device:
    """Synchronisation on one device; on the CPU every call is done when it
    returns."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self):
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    @staticmethod
    def wait(mark) -> None:
        if mark is not None:
            mark.synchronize()


class Sampler:
    """A uniform sample of `size` calls' outputs, drawn from the seed
    (reservoir sampling over the calls of the window)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed ^ 0x5A3D1E)
        self.kept: dict = {}

    def offer(self, i: int, outputs) -> None:
        if i < self.size:
            self.kept[i] = outputs
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = outputs


def loop(call, st, dev: Device, in_flight: int, seconds=None, calls=None,
         sampler=None, api=None, latencies=None, issued=None) -> int:
    """Issue `call(st, i)` until `seconds` have passed or `calls` were issued, at
    most `in_flight` outstanding; return the number issued (their issue
    times appended to `issued`). The caller synchronises after it."""
    marks = collections.deque()
    end = None if seconds is None else time.perf_counter() + seconds
    i = 0
    while (calls is None or i < calls) and (end is None
                                            or time.perf_counter() < end):
        if len(marks) >= in_flight:
            dev.wait(marks.popleft())
        t0 = time.perf_counter()
        if issued is not None:
            issued.append(t0)
        outputs = call(st, i)
        if api is not None:
            api.append(time.perf_counter() - t0)
        if in_flight == 1:
            dev.sync()
            if latencies is not None:
                latencies.append(time.perf_counter() - t0)
        else:
            marks.append(dev.mark())
        if sampler is not None:
            sampler.offer(i, outputs)
        i += 1
    return i


def check(op, st, kept: dict):
    """The sampled calls' outputs against the plain reference: the
    numbers compared, each {"value": words of an output that differ,
    "limit"}; the calls with any difference; and whether the run is
    correct: some calls kept, and every number within its limit."""
    totals = [0] * len(op.OUTPUTS)
    failed = 0
    by_key = collections.defaultdict(list)
    for i, outputs in kept.items():
        by_key[op.key(st, i)].append(outputs)
    for k, group in by_key.items():
        expected = op.reference(st, k)
        for outputs in group:
            counts = [int((o != e).sum()) for o, e in zip(outputs, expected)]
            totals = [a + b for a, b in zip(totals, counts)]
            failed += any(counts)
    checks = {f"{name}_mismatch": {"value": v,
                                   "limit": op.LIMITS[f"{name}_mismatch"]}
              for name, v in zip(op.OUTPUTS, totals)}
    correct = len(kept) > 0 and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    return checks, failed, correct


def run_cell(reg, cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, call=None):
    """Run one cell once; return (result, checks, notes): the result's
    line (without its checks), the numbers compared with their limits, and
    lines worth printing before them. `call(st, i)` replaces the
    operation's own call (the control puts the reference there)."""
    from hexl_tpu_torch import _build   # the program's launch counter

    phases = [("program imported", time.perf_counter() - t_start)]
    entry = reg.workload(cell)
    cfg = reg.config(entry["config"])
    tr = reg.traffic(entry["traffic"])
    op = reg.module("ops", tr["op"])
    dev = Device(device)
    spans = {}

    @contextlib.contextmanager
    def span(name):
        t0 = time.perf_counter()
        yield
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0

    ctx = SimpleNamespace(config=cfg, traffic=tr, seed=seed, device=device,
                          span=span)
    st = op.setup(ctx)
    call = call or op.call
    phases.append(("inputs and plans made", time.perf_counter() - t_start))
    in_flight = int(tr["in_flight"])
    loop(call, st, dev, in_flight, calls=max(2, in_flight))
    dev.sync()
    phases.append(("warmed up", time.perf_counter() - t_start))
    if dev.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sampler = Sampler(int(tr["sample"]), seed)
    api, latencies = ([] if trace else None), []
    before = collections.Counter(_build.launches)
    setup_s = time.perf_counter() - t_start
    issued = []
    cpu0, t0 = time.process_time(), time.perf_counter()
    calls = loop(call, st, dev, in_flight, seconds=seconds, sampler=sampler,
                 api=api, latencies=latencies, issued=issued)
    dev.sync()
    window_s = time.perf_counter() - t0
    cpu_share = (time.process_time() - cpu0) / window_s
    per_second = collections.Counter(int(t - t0) for t in issued)
    del issued
    launches = collections.Counter(_build.launches)
    launches.subtract(before)
    summary = None
    if trace:
        trace_calls = int(tr["trace_calls"])
        summary = tracing.profile(lambda: loop(call, st, dev, in_flight,
                                               calls=trace_calls))
    peak = torch.cuda.max_memory_allocated(device) if dev.cuda else 0
    kind = torch.cuda.get_device_name(device) if dev.cuda else "cpu"
    op.release(st)
    if dev.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed, correct = check(op, st, sampler.kept)
    check_s = time.perf_counter() - t_check
    least = roofline.least_time(
        reg.module("roofline", tr["op"]).counts(**op.shape(st)), kind)
    run = SimpleNamespace(
        unit=op.UNIT, calls=calls, units=calls * op.units(st),
        window_s=window_s, latencies_s=latencies, api_s=api,
        launches=sum(launches.values()), setup_s=setup_s, spans=spans,
        trace=summary, trace_calls=int(tr["trace_calls"]) if trace else 0,
        least_s=None if least is None else least[0])
    metrics = {}
    for m in reg.metrics(cell, trace):
        value = reg.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": calls, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.cuda else "cpu",
                         "kind": kind, "count": int(entry["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    notes = [f"cell {cell}: set-up {setup_s:.3f} s (plans "
             f"{spans.get('plan_setup', 0.0):.3f} s), window "
             f"{window_s:.3f} s, {calls} calls, {run.units} {op.UNIT}s, "
             f"{len(sampler.kept)} checked in {check_s:.3f} s",
             "set-up phases (s from start): " + ", ".join(
                 f"{name} {t:.3f}" for name, t in phases),
             f"launches in the window: {dict(launches)}",
             f"host: the process used {100 * cpu_share:.1f}% of a core in "
             f"the window; calls issued in each second "
             f"{[per_second[k] for k in sorted(per_second)]}"]
    if least is not None:
        notes.append(f"roofline: least {least[0] * 1e6:.3f} us a call, "
                     f"bound by {least[1]}")
    return result, checks, notes
