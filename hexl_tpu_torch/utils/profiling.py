"""Profiling: the port's counterpart of `hexl_tpu/utils/profiling.py`, and
the spans inside its public calls.

  * trace(log_dir): a context manager around `torch.profiler.profile` that
    records the host (CPU activity) and, where a card is present, the
    device (CUDA activity), and writes a Chrome-trace JSON into `log_dir`.
  * recording(): a context manager that keeps the spans of the calling
    process in memory while it is open and yields the list of records.
  * summary(records): each span name's count, inclusive and self seconds.

The spans. Each public call tests `on()` once: with no recording open and
the torch profiler off it runs as if there were no spans (no span object,
no clock read, no context entered); `_build.launch_on` tests `records`
once a launch. Otherwise the public call (`hexl.dyadic_multiply`,
`hexl.key_switch`, `hexl.rns_ntt.forward`, `hexl.rns_ntt.inverse`) runs
inside a span of its name, its operand and argument handling inside
`hexl.checks`, and its steps inside spans of theirs: `hexl.ks.<entry>` for
each step of the key switch's pipeline (`key_switch.TRACED`), `hexl.dyadic`
for K9's wrapper, `hexl.rns_ntt.route` for the stacked transform's route
and launches. Every launch through `launch_on` is `hexl.launch` (device
guard, stream read, the C entry) while a recording is open. So a public
call's inclusive time is the self time of its own span (the glue between
steps), of the steps, of `hexl.checks` and of `hexl.launch`.

While the torch profiler is on (`trace`, or any `torch.profiler.profile`),
every span but `hexl.launch` also opens `torch.profiler.record_function`
of its name, so it lands in the Chrome trace as a `user_annotation` on the
kernels' clock; `hexl.launch` is left out, since the profiler records
`cudaLaunchKernel` itself and an annotation costs far more than a launch.
A recording times the spans with `time.perf_counter_ns` and writes nothing
out. Spans are taken for one thread at a time.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

CHECKS = "hexl.checks"
LAUNCH = "hexl.launch"

# The open recording's list of records, or None: the flag every public call
# and every launch tests.
records: list | None = None
_open: list = []     # indices of the open records, innermost last


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile what runs inside the block into a Chrome trace in `log_dir`.

    Yields the path of the JSON file, which is written when the block
    ends. With a card present the trace also records CUDA activity (the
    kernels, whether launched by PyTorch or through the port's C entries)
    after synchronising the device; if it then holds no kernel event the
    device was not traced, and this raises rather than hand back a trace of
    the host alone. The port's spans appear in it as annotations."""
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


def on() -> bool:
    """Whether the public calls take spans: a recording is open or the
    torch profiler is on."""
    return records is not None or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record the process's spans in memory while the block runs; yields
    the list of records, each (name, start_ns, end_ns, parent, call):
    `parent` is the index of the enclosing record or -1, `call` the index
    of the outermost record it lies in (its own for an outermost one), so
    every span of one public call shares it. A record is a tuple once its
    span has ended. Recordings do not nest."""
    global records
    if records is not None:
        raise RuntimeError("hexl_tpu_torch: a recording is already open")
    records = []
    _open.clear()
    try:
        yield records
    finally:
        records = None
        _open.clear()


class Span:
    """A span of the name: a record while a recording is open, and, where
    `annotate` and the torch profiler is on, a `record_function` around
    it. Entered only where `on()` (or, for a launch, `records`) said so."""

    __slots__ = ("name", "annotate", "_records", "_index", "_function")

    def __init__(self, name: str, annotate: bool = True):
        self.name = name
        self.annotate = annotate

    def __enter__(self) -> "Span":
        self._function = None
        if self.annotate and _autograd_profiler._is_profiler_enabled:
            self._function = torch.profiler.record_function(self.name)
            self._function.__enter__()
        self._records = recs = records
        if recs is not None:
            parent = _open[-1] if _open else -1
            self._index = index = len(recs)
            call = recs[parent][4] if parent >= 0 else index
            recs.append([self.name, time.perf_counter_ns(), None, parent,
                         call])
            _open.append(index)
        return self

    def __exit__(self, *exc) -> bool:
        recs = self._records
        if recs is not None:
            end = time.perf_counter_ns()
            name, start, _, parent, call = recs[self._index]
            recs[self._index] = (name, start, end, parent, call)
            if _open and _open[-1] == self._index:
                _open.pop()
        if self._function is not None:
            self._function.__exit__(*exc)
        return False


def traced(name: str, fn):
    """fn, each call of it inside a span `name` (for step tables taken
    only where `on()`)."""
    def step(*args, **kwargs):
        with Span(name):
            return fn(*args, **kwargs)
    return step


def summary(recs) -> dict:
    """{name: {"count", "total_s", "self_s"}} over the ended records:
    `total_s` their inclusive time, `self_s` the part of it that no child
    span covers."""
    children = collections.Counter()
    for name, start, end, parent, _ in recs:
        if end is not None and parent >= 0:
            children[parent] += end - start
    out: dict = {}
    for i, (name, start, end, _, _) in enumerate(recs):
        if end is None:
            continue
        s = out.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += (end - start) * 1e-9
        s["self_s"] += (end - start - children[i]) * 1e-9
    return out
