"""The reduction of a Chrome trace to busy time, kernel time, the device
operations and the idle gaps, on a hand-made trace; and the idle share
read from it against the untraced window."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from hebench import readers, tracing


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize():
    events = [
        ev("user_annotation", tracing.WINDOW, 0, 100),
        ev("kernel", "void k1<3>(int, long)", 10, 20),
        ev("kernel", "void k1<3>(int, long)", 25, 15),     # overlaps k1
        ev("gpu_memcpy", "Memcpy DtoD", 60, 10),
        ev("kernel", "void k2(int)", 95, 10),              # cut at 100
        ev("cpu_op", "aten::empty", 42, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 45, 2),
        ev("python_function", "outer", 0, 100),
    ]
    s = tracing.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    # busy: [10, 40] + [60, 70] + [95, 100]
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["kernel_s"] == pytest.approx(40e-6)
    assert s["device_ops"][0] == ["void k1<3>", pytest.approx(35e-6)]
    gaps = dict(s["idle_gaps"])
    # [0, 10], [70, 95]: "outer"; [40, 60] (middle 50): aten::empty.
    assert gaps["outer"] == pytest.approx(35e-6)
    assert gaps["aten::empty"] == pytest.approx(20e-6)


def test_a_trace_without_kernels_is_refused():
    with pytest.raises(RuntimeError):
        tracing.summarize([ev("user_annotation", tracing.WINDOW, 0, 10)])


def test_the_idle_share_divides_by_the_untraced_window():
    # 10 traced calls busy 4 ms on the device in a 20 ms traced window;
    # the untraced window ran 100 calls in 50 ms: 0.4 of 0.5 ms a call.
    run = SimpleNamespace(trace={"busy_s": 4e-3, "window_s": 20e-3},
                          trace_calls=10, calls=100, window_s=50e-3)
    assert readers.device_idle_pct(run) == pytest.approx(20.0)
    run.trace = None
    assert readers.device_idle_pct(run) is None
