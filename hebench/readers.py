"""What the metric readers (`metrics/<name>.py`) share. Each takes the
run's record (`harness.run_cell`) and returns a number, or None where the
run has nothing for it to read."""

from __future__ import annotations

import statistics


def rate(run, unit: str):
    """Units of `unit` completed per second of the window."""
    if run.unit != unit or run.window_s <= 0 or run.calls == 0:
        return None
    return run.units / run.window_s


def p95_ms(run, unit: str):
    """The 95th percentile of the window's call latencies, in ms."""
    if run.unit != unit or len(run.latencies_s) < 20:
        return None
    return statistics.quantiles(run.latencies_s, n=20)[-1] * 1e3


def api_host_ms(run):
    """Mean host time for the public calls of one operation to return."""
    if not run.api_s:
        return None
    return sum(run.api_s) / len(run.api_s) * 1e3


def launches_per_op(run):
    """The program's kernel launches (`_build.launches`) per operation."""
    if run.calls == 0:
        return None
    return run.launches / run.calls


def roofline_pct(run):
    """The operation's least time over its device kernel time, in %."""
    if run.trace is None or run.least_s is None or run.trace_calls == 0 \
            or run.trace["kernel_s"] <= 0:
        return None
    return 100.0 * run.least_s * run.trace_calls / run.trace["kernel_s"]


def device_idle_pct(run):
    """The share of the untraced window in which the device ran nothing:
    one less the device's busy time a call, from the trace, over the
    untraced window's time a call. The profiler slows the host, so the
    traced window's own idle share reads high where the host paces."""
    if run.trace is None or run.trace_calls == 0 or run.calls == 0 \
            or run.window_s <= 0:
        return None
    busy = run.trace["busy_s"] / run.trace_calls
    return 100.0 * (1.0 - busy / (run.window_s / run.calls))


def span_s(run, name: str):
    return run.spans.get(name)
