"""The program's own spans over one cell's calls: the split of a public
call's host time into checks, glue, steps and launches.

    python3 hebench/spans.py --workload <cell> --seed <n> --seconds <s>

sets the cell up as `harness.run_cell` does and warms up, runs an untraced
window of `--seconds`, then four turns of `trace_calls` untraced calls
and `trace_calls` calls inside `hexl_tpu_torch.utils.profiling.
recording()`, each call timed from its issue to its return (as
`api_host_ms` is), and prints one JSON line: each window's host ms a call,
the recorded calls' split (`parts_ms`), each span's count and self ms a
call, the plan caches' counts, and what one span and one
`record_function` cost. It reads what the program records; a program
without `profiling.recording` has nothing for it. `parts_ms` is what a
span window in `run_cell` would give the `host_*_ms` readers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import sys
import time
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent.parent
PUBLIC = ("hexl.dyadic_multiply", "hexl.key_switch", "hexl.rns_ntt.forward",
          "hexl.rns_ntt.inverse")
CHECKS = "hexl.checks"
LAUNCH = "hexl.launch"
ROUNDS = 4


def parts_ms(summary: dict, calls: int) -> dict:
    """A call's host ms in the program's public calls (`public`, their
    inclusive time) and its parts, which sum to it: `checks` (inclusive
    `hexl.checks`), `launch` (inclusive `hexl.launch`), `glue` (the public
    spans' self time: the Python between steps) and `steps` (the self time
    of every other span: the steps' Python and torch ops, their launches
    and checks excluded)."""
    def total(names, key):
        return sum(summary[k][key] for k in names if k in summary)

    rest = [k for k in summary if k not in PUBLIC + (CHECKS, LAUNCH)]
    parts = {"checks": total([CHECKS], "total_s"),
             "glue": total(PUBLIC, "self_s"),
             "steps": total(rest, "self_s"),
             "launch": total([LAUNCH], "total_s"),
             "public": total(PUBLIC, "total_s")}
    return {k: v / calls * 1e3 for k, v in parts.items()}


def cost_us(make, repeat: int = 2000) -> float:
    """Microseconds to enter and leave `make()`'s context, a mean over
    `repeat`."""
    t0 = time.perf_counter()
    for _ in range(repeat):
        with make():
            pass
    return (time.perf_counter() - t0) / repeat * 1e6


def measure(reg, cell: str, seed: int, seconds: float, rounds: int,
            device) -> dict:
    """Run `cell` as the module docstring says; return the line's fields."""
    import torch

    from hebench import harness
    from hexl_tpu_torch.ntt import plan
    from hexl_tpu_torch.utils import profiling

    entry = reg.workload(cell)
    tr = reg.traffic(entry["traffic"])
    op = reg.module("ops", tr["op"])
    dev = harness.Device(device)
    ctx = SimpleNamespace(config=reg.config(entry["config"]), traffic=tr,
                          seed=seed, device=device,
                          span=lambda name: contextlib.nullcontext())
    st = op.setup(ctx)
    in_flight, calls = int(tr["in_flight"]), int(tr["trace_calls"])
    harness.loop(op.call, st, dev, in_flight, calls=max(2, in_flight))
    dev.sync()
    build_s = plan.cache_stats["build_s"]
    window = []
    harness.loop(op.call, st, dev, in_flight, seconds=seconds, api=window)
    dev.sync()
    plain, spanned, summary = [], [], {}
    before = dict(plan.cache_stats)
    for _ in range(rounds):
        api = []
        harness.loop(op.call, st, dev, in_flight, calls=calls, api=api)
        dev.sync()
        plain.append(statistics.fmean(api) * 1e3)
        api = []
        with profiling.recording() as recs:
            harness.loop(op.call, st, dev, in_flight, calls=calls, api=api)
            dev.sync()
        spanned.append(statistics.fmean(api) * 1e3)
        for name, got in profiling.summary(recs).items():
            s = summary.setdefault(name, dict.fromkeys(got, 0))
            for k, v in got.items():
                s[k] += v
    stats = {k: v - before.get(k, 0) for k, v in plan.cache_stats.items()}
    with profiling.recording():
        span_us = cost_us(lambda: profiling.Span("hexl.cost"))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        annotation_us = cost_us(
            lambda: torch.profiler.record_function("hexl.cost"))
    op.release(st)
    n = rounds * calls
    parts = parts_ms(summary, n)
    return {
        "cell": cell, "device": (torch.cuda.get_device_name(device)
                                 if dev.cuda else "cpu"),
        "calls_recorded": n,
        "window_host_ms": statistics.fmean(window) * 1e3,
        "plain_host_ms": plain, "spans_host_ms": spanned,
        "parts_ms": parts,
        "parts_over_public": sum(parts[k] for k in ("checks", "glue",
                                                    "steps", "launch"))
        / parts["public"],
        "public_over_spans_host": parts["public"]
        / statistics.fmean(spanned),
        "spans": {k: {"count": v["count"] / n,
                      "self_ms": v["self_s"] / n * 1e3}
                  for k, v in sorted(summary.items(),
                                     key=lambda kv: -kv[1]["self_s"])},
        "annotated_per_call": sum(v["count"] for k, v in summary.items()
                                  if k != LAUNCH) / n,
        "plan_build_s_setup": build_s,
        "plan_cache_in_rounds": stats,
        "span_us": span_us, "record_function_us": annotation_us}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from hebench import registry

    if not torch.cuda.is_available():
        print("hebench.spans: needs a CUDA device; no result",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    reg = registry.Registry(registry.load_benchmark(ROOT), ROOT)
    out = measure(reg, args.workload, args.seed, args.seconds, ROUNDS,
                  torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
