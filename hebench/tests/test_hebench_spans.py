"""The readers of what the program records: `plan_build_s` (the plan
caches' build seconds) and `spans.parts_ms` (a public call's split into
checks, glue, steps and launches) on hand-made records, and both on the
CPU through the harness's own loop."""

from __future__ import annotations

import time

import pytest
import torch

from hebench import harness, spans, tracing
from hebench.tests.conftest import ROOT  # noqa: F401  (puts ROOT on sys.path)

CPU = torch.device("cpu")


def s(total, self_=None, count=1):
    return {"count": count, "total_s": total,
            "self_s": total if self_ is None else self_}


def test_parts_ms_on_a_hand_made_summary():
    # Two calls: dyadic_multiply 3 ms (1 self, checks 0.5, its step 1.5 of
    # which 0.5 is a launch); key_switch 7 ms (2 self, checks 1, steps 4
    # of which 1 is launches).
    summary = {"hexl.dyadic_multiply": s(3e-3, 1e-3, 2),
               "hexl.key_switch": s(7e-3, 2e-3, 2),
               "hexl.checks": s(1.5e-3, count=6),
               "hexl.dyadic": s(1.5e-3, 1e-3, 2),
               "hexl.ks.fwd": s(4e-3, 3e-3, 4),
               "hexl.launch": s(1.5e-3, count=32)}
    got = spans.parts_ms(summary, 2)
    assert got == pytest.approx({"checks": 0.75, "glue": 1.5, "steps": 2.0,
                                 "launch": 0.75, "public": 5.0})
    assert sum(got[k] for k in ("checks", "glue", "steps", "launch")) \
        == pytest.approx(got["public"])


def test_plan_build_s_reads_the_program_counter(tiny, monkeypatch):
    from hexl_tpu_torch.ntt import get_plan, plan

    read = tiny.module("metrics", "plan_build_s").read
    get_plan(16, 97)
    assert read(None) == plan.cache_stats["build_s"] > 0
    # A program without the counter (the parent of the spans) gives none.
    monkeypatch.delattr(plan, "cache_stats")
    assert read(None) is None


def test_a_traced_run_reports_plan_build_s(tiny, monkeypatch):
    def profile(fn):
        fn()
        return {"busy_s": 1e-3, "window_s": 2e-3, "kernel_s": 1e-3,
                "device_ops": [], "idle_gaps": []}

    monkeypatch.setattr(tracing, "profile", profile)
    result, _, _ = harness.run_cell(tiny, "tiny-mult", 2**31 + 11, 0.2,
                                    True, CPU, time.perf_counter())
    assert result["correct"]
    assert result["metrics"]["plan_build_s"]["value"] > 0
    assert result["metrics"]["plan_build_s"]["unit"] == "s"


@pytest.mark.parametrize("cell,public", [
    ("tiny-mult", {"hexl.dyadic_multiply", "hexl.key_switch"}),
    ("tiny-ntt", {"hexl.rns_ntt.forward", "hexl.rns_ntt.inverse"}),
])
def test_the_span_tool_on_the_cpu(tiny, cell, public):
    out = spans.measure(tiny, cell, 2**31 + 21, 0.1, 2, CPU)
    assert out["device"] == "cpu" and out["calls_recorded"] == 8
    assert out["parts_over_public"] == pytest.approx(1.0, rel=1e-9)
    assert 0 < out["public_over_spans_host"] <= 1.0
    assert public <= set(out["spans"])
    assert all(out["spans"][p]["count"] == 1 for p in public)
    assert "hexl.launch" not in out["spans"]      # no launch on the CPU
    assert out["plan_cache_in_rounds"].get("misses", 0) == 0
    assert len(out["plain_host_ms"]) == len(out["spans_host_ms"]) == 2
    assert out["span_us"] > 0 and out["record_function_us"] > 0
