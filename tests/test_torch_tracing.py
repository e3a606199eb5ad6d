"""The port's spans and plan-cache counters (`utils/profiling.py`,
`ntt/plan.py::cache_stats`): records and their nesting, self time, the
partition of a public call's time into glue, checks, steps and launches,
the off path (no span, no clock), outputs equal with and without spans, the
annotations under `trace`, and the counters' misses, build time and hits."""

import collections
import contextlib
import importlib
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hexl_tpu_torch import (RnsNTT, _build, dyadic_multiply, key_switch,
                            nt)
from hexl_tpu_torch.ntt import get_plan, get_rns_plan, plan
from hexl_tpu_torch.utils import profiling
from hexl_tpu_torch.utils.profiling import Span, recording, summary

# The module, which the function of its name shadows in `experimental`.
ks_module = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
PUBLIC = {"hexl.dyadic_multiply", "hexl.key_switch", "hexl.rns_ntt.forward",
          "hexl.rns_ntt.inverse"}
# The steps `pipeline` takes on its stacked branch (ds > 1, distinct primes).
STACKED_STEPS = {"constants", "approx", "plan", "rns_plan", "inv_rns",
                 "others", "reduce_rows", "reduce", "fwd", "fwd_rns",
                 "assemble", "take", "mac_flush", "inv", "spread", "fold"}


def _rows(rng, moduli, n, lead=()):
    """int64 residues (lead..., len(moduli), n), row i below moduli[i]."""
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, size=lead + (n,), dtype=np.uint64)
         for q in moduli], axis=len(lead)).view(np.int64))


def ks_case(n=64, ds=3, kc=2, bits=40):
    """The key switch's arguments at (n, ds, kc) on the CPU, as tensors."""
    moduli = nt.generate_primes(ds + 1, bits, True, ntt_size=n)
    rng = np.random.default_rng(n + ds)
    keys = torch.stack([torch.stack([_rows(rng, moduli, n)
                                     for _ in range(kc)])
                        for _ in range(ds)])
    result = torch.stack([_rows(rng, moduli[:ds], n) for _ in range(kc)])
    msf = [pow(moduli[-1], -1, q) for q in moduli[:ds]]
    return (result, _rows(rng, moduli[:ds], n), n, ds, ds + 1, ds + 1, kc,
            moduli, keys, msf)


def dyadic_case(n=64, m=3):
    moduli = nt.generate_primes(m, 45, True, ntt_size=n)
    rng = np.random.default_rng(m)
    return (_rows(rng, moduli, n, (2,)), _rows(rng, moduli, n, (2,)),
            moduli)


def rns_case(n=64, k=3, polys=2):
    moduli = nt.generate_primes(k, 50, True, ntt_size=n)
    rng = np.random.default_rng(k)
    x = torch.stack([torch.from_numpy(rng.integers(
        0, q, size=(polys, n), dtype=np.uint64).view(np.int64))
        for q in moduli])
    return RnsNTT(n, moduli, device="cpu"), x


def run_ks():
    return key_switch(*ks_case())


def run_dyadic():
    return dyadic_multiply(*dyadic_case())


def run_rns():
    rns, x = rns_case()
    return rns.inverse(rns.forward(x))


CALLS = {"key_switch": run_ks, "dyadic_multiply": run_dyadic,
         "rns_ntt": run_rns}


def parts(s: dict) -> tuple:
    """(glue + checks + steps + launch, the public spans' inclusive time)
    of a summary."""
    glue = sum(v["self_s"] for k, v in s.items() if k in PUBLIC)
    checks = s.get(profiling.CHECKS, {}).get("total_s", 0.0)
    launch = s.get(profiling.LAUNCH, {}).get("total_s", 0.0)
    steps = sum(v["self_s"] for k, v in s.items()
                if k not in PUBLIC | {profiling.CHECKS, profiling.LAUNCH})
    public = sum(v["total_s"] for k, v in s.items() if k in PUBLIC)
    return glue + checks + steps + launch, public


# -- the recorder ----------------------------------------------------------

def test_records_nest_with_parent_and_call_ids():
    with recording() as recs:
        with Span("a"):
            with Span("b"):
                with Span("c"):
                    pass
            with Span("d"):
                pass
        with Span("e"):
            pass
    assert [r[0] for r in recs] == ["a", "b", "c", "d", "e"]
    assert [r[3] for r in recs] == [-1, 0, 1, 0, -1]
    assert [r[4] for r in recs] == [0, 0, 0, 0, 4]
    for name, start, end, _, _ in recs:
        assert 0 < start <= end
    assert all(isinstance(r, tuple) and len(r) == 5 for r in recs)
    assert recs[0][1] <= recs[1][1] <= recs[2][2] <= recs[1][2] \
        <= recs[3][1] <= recs[3][2] <= recs[0][2] <= recs[4][1]


def test_recording_is_off_outside_its_block_and_does_not_nest():
    assert profiling.records is None and not profiling.on()
    with recording() as recs:
        assert profiling.records is recs and profiling.on()
        with pytest.raises(RuntimeError, match="already open"):
            with recording():
                pass
    assert profiling.records is None
    with Span("outside"):
        pass
    assert recs == []


@pytest.mark.parametrize("recs,want", [
    # One span, no children: self == total.
    ([("a", 0, 10, -1, 0)], {"a": (1, 10, 10)}),
    # Two children of one parent, a grandchild under the first.
    ([("p", 0, 100, -1, 0), ("c", 10, 40, 0, 0), ("g", 20, 25, 1, 0),
      ("c", 50, 70, 0, 0)],
     {"p": (1, 100, 50), "c": (2, 50, 45), "g": (1, 5, 5)}),
    # Two calls of the same names; an open record is left out.
    ([("p", 0, 10, -1, 0), ("c", 2, 6, 0, 0), ("p", 20, 26, -1, 2),
      ("c", 21, 22, 2, 2), ("c", 30, None, -1, 4)],
     {"p": (2, 16, 11), "c": (2, 5, 5)}),
])
def test_summary_self_time_on_hand_made_records(recs, want):
    got = summary(recs)
    assert set(got) == set(want)
    for name, (count, total, self_) in want.items():
        assert got[name]["count"] == count
        assert got[name]["total_s"] == pytest.approx(total * 1e-9)
        assert got[name]["self_s"] == pytest.approx(self_ * 1e-9)


# -- the spans of the public calls -----------------------------------------

@pytest.mark.parametrize("ds", [1, 3])
def test_key_switch_time_is_glue_checks_steps_and_launches(ds):
    args = ks_case(ds=ds)
    key_switch(*args)
    with recording() as recs:
        key_switch(*args)
    s = summary(recs)
    assert s["hexl.key_switch"]["count"] == 1
    assert s[profiling.CHECKS]["count"] == 1
    assert {r[4] for r in recs} == {0}
    total, public = parts(s)
    assert total == pytest.approx(public, rel=1e-9)
    steps = {k[len("hexl.ks."):] for k in s if k.startswith("hexl.ks.")}
    if ds > 1:
        assert steps == STACKED_STEPS
    else:
        assert {"inv", "fwd", "take", "stack", "mac_flush", "spread",
                "fold"} <= steps


def test_every_step_of_the_pipeline_has_its_span():
    for name, step in vars(ks_module.WRAPPERS).items():
        traced = getattr(ks_module.TRACED, name)
        if not callable(step):
            assert traced is step
            continue
        with recording() as recs:
            with pytest.raises(TypeError):
                traced()
        assert [r[0] for r in recs] == [f"hexl.ks.{name}"]


def test_dyadic_multiply_spans():
    args = dyadic_case()
    with recording() as recs:
        dyadic_multiply(*args)
    tree = [(r[0], recs[r[3]][0] if r[3] >= 0 else None) for r in recs]
    assert tree == [("hexl.dyadic_multiply", None),
                    (profiling.CHECKS, "hexl.dyadic_multiply"),
                    ("hexl.dyadic", "hexl.dyadic_multiply"),
                    (profiling.CHECKS, "hexl.dyadic")]
    total, public = parts(summary(recs))
    assert total == pytest.approx(public, rel=1e-9)


def test_rns_ntt_spans():
    rns, x = rns_case()
    with recording() as recs:
        rns.inverse(rns.forward(x))
    names = [r[0] for r in recs]
    assert names == ["hexl.rns_ntt.forward", profiling.CHECKS,
                     "hexl.rns_ntt.route", "hexl.rns_ntt.inverse",
                     profiling.CHECKS, "hexl.rns_ntt.route"]
    assert [r[4] for r in recs] == [0, 0, 0, 3, 3, 3]


def test_launch_on_is_a_launch_span(monkeypatch):
    """launch_on with a Python C entry returning 0, its torch.cuda calls
    replaced: one `hexl.launch` a launch, which the partition counts."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(_build, "launches", collections.Counter())
    seen = []

    def entry(*args):
        seen.append(args)
        time.sleep(0.001)
        return 0

    with recording() as recs:
        with Span("hexl.key_switch"):
            with Span("hexl.ks.fold"):
                for _ in range(3):
                    _build.launch_on(torch.device("cpu"), "K11", entry, 1, 2)
    _build.launch_on(torch.device("cpu"), "K11", entry, 3)
    assert seen == [(1, 2, 7)] * 3 + [(3, 7)]
    assert _build.launches == {"K11": 4}
    s = summary(recs)
    assert s[profiling.LAUNCH]["count"] == 3
    assert s[profiling.LAUNCH]["total_s"] >= 3e-3
    assert [r[3] for r in recs if r[0] == profiling.LAUNCH] == [1, 1, 1]
    total, public = parts(s)
    assert total == pytest.approx(public, rel=1e-9)


# -- the off path ----------------------------------------------------------

@pytest.mark.parametrize("call", sorted(CALLS))
def test_off_path_takes_no_span_and_reads_no_clock(monkeypatch, call):
    CALLS[call]()       # plans built

    def refuse(*args, **kwargs):
        raise AssertionError("a span on the off path")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(profiling, "Span", refuse)
    assert not profiling.on()
    CALLS[call]()
    with pytest.raises(AssertionError):
        with recording():
            CALLS[call]()


@pytest.mark.parametrize("call", sorted(CALLS))
def test_spans_leave_the_outputs_as_they_are(call):
    plain = CALLS[call]()
    with recording() as recs:
        spanned = CALLS[call]()
    assert recs
    assert torch.equal(plain, spanned)


def test_trace_annotates_the_public_calls_and_steps(tmp_path):
    run_ks()
    with profiling.trace(str(tmp_path)) as path:
        assert profiling.on() and profiling.records is None
        run_ks()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    assert names["hexl.key_switch"] == 1
    assert names[profiling.CHECKS] == 1
    assert {f"hexl.ks.{s}" for s in STACKED_STEPS} <= set(names)
    assert profiling.LAUNCH not in names


def test_a_launch_is_not_annotated(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "launches", collections.Counter())
    with profiling.trace(str(tmp_path)) as path:
        with recording() as recs:
            _build.launch_on(torch.device("cpu"), "K9", lambda *a: 0)
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert [r[0] for r in recs] == [profiling.LAUNCH]
    assert profiling.LAUNCH not in names


# -- the plan caches' counters ---------------------------------------------

def _fresh_prime(n: int) -> int:
    """A prime = 1 mod 2n that no plan of degree n has used yet."""
    for q in nt.generate_primes(64, 58, True, ntt_size=n):
        if (n, q) not in plan._PLAN_CACHE:
            return q
    raise AssertionError("no fresh prime")


@pytest.mark.parametrize("which", ["get_plan", "get_rns_plan"])
def test_one_miss_then_hits_counted_only_while_recording(which):
    n = 32
    q = _fresh_prime(n)
    get = ((lambda: get_plan(n, q)) if which == "get_plan"
           else (lambda: get_rns_plan(n, [q])))
    before = dict(plan.cache_stats)
    get()
    after = plan.cache_stats
    # get_rns_plan builds its prime's plan too: two misses, timed once.
    assert after["misses"] - before.get("misses", 0) == (
        1 if which == "get_plan" else 2)
    assert after["build_s"] > before.get("build_s", 0.0)
    build_s, hits = after["build_s"], after["hits"]
    get()
    assert plan.cache_stats["hits"] == hits
    with recording():
        get()
        get()
    assert plan.cache_stats["hits"] == hits + 2
    assert plan.cache_stats["build_s"] == build_s


def test_device_copies_count_and_clearing_keeps_the_counts():
    n = 64
    q = _fresh_prime(n)
    before = plan.cache_stats["misses"]
    rplan = get_rns_plan(n, [q], "cpu")
    # The stacked plan, its prime's plan, the tables on the CPU (inside
    # the descriptors' build), the descriptors.
    assert plan.cache_stats["misses"] == before + 4
    rplan.descriptors("cpu")
    get_plan(n, q, "cpu")
    assert plan.cache_stats["misses"] == before + 4
    stats = dict(plan.cache_stats)
    plan.clear_plan_cache()
    assert dict(plan.cache_stats) == stats
