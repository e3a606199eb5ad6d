"""The harness on the CPU: the registry, BENCHMARK.json against the
contract's characters, a cell added as data files alone, runs that load
neither JAX nor the JAX package, a refusal without a card, and the
faults that `correct` must catch. The card's own test is marked `gpu`."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from hebench import harness, registry
from hebench.tests.conftest import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
CPU = torch.device("cpu")


def run(reg, cell, seed=2**31 + 77, seconds=0.3, trace=False):
    return harness.run_cell(reg, cell, seed, seconds, trace, CPU,
                            time.perf_counter())


def test_the_registry_finds_every_part_by_name():
    bench = registry.load_benchmark(ROOT)
    reg = registry.Registry(bench, ROOT)
    for c in bench["configs"]:
        cfg = reg.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
    for w in bench["workloads"]:
        op = reg.traffic(w["traffic"])["op"]
        assert reg.module("ops", op).OUTPUTS
        assert reg.module("roofline", op).counts
        reg.config(w["config"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reg.module("metrics", m["name"]).read)


def test_benchmark_json_keeps_to_the_contract():
    bench = registry.load_benchmark(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"] if "workloads" in m else []) <= {
            w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in bench["configs"]:
        assert c["file"].startswith("hebench/") and len(c["source"]) <= 200
    for root, _, files in os.walk(ROOT / "hebench"):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_a_cell_is_added_as_data_files_alone(tiny):
    result, checks, _ = run(tiny, "tiny-mult")
    assert result["correct"] and result["attempted"] > 0
    assert set(result["metrics"]) == {"he_mult_per_s", "setup_s"}
    assert set(checks) == {"prod_mismatch", "relin_mismatch"}
    result, _, _ = run(tiny, "tiny-ntt")
    assert result["correct"]
    assert set(result["metrics"]) == {"ntt_limbs_per_s", "setup_s"}
    result, _, _ = run(tiny, "tiny-latency", seconds=0.5)
    assert result["correct"]
    assert set(result["metrics"]) == {"he_mult_p95_ms", "setup_s"}


class Fault:
    """The program's public functions, broken underneath the harness."""

    @staticmethod
    def state_unchanged(program, monkeypatch):
        monkeypatch.setattr(program, "key_switch",
                            lambda result, *a, **k: result.clone())

    @staticmethod
    def half_the_batch(program, monkeypatch):
        cls = program.RnsNTT

        class Half(cls):
            def forward(self, x, *a):
                y = x.clone()
                h = x.shape[1] // 2
                y[:, :h] = cls.forward(self, x[:, :h].contiguous(), *a)
                return y
        monkeypatch.setattr(program, "RnsNTT", Half)

    @staticmethod
    def altered_product(program, monkeypatch):
        real = program.dyadic_multiply

        def altered(*a, **k):
            out = real(*a, **k)
            out[1, 0, 3] ^= 1
            return out
        monkeypatch.setattr(program, "dyadic_multiply", altered)

    @staticmethod
    def altered_inverse(program, monkeypatch):
        cls = program.RnsNTT

        class Altered(cls):
            def inverse(self, x, *a):
                y = cls.inverse(self, x, *a)
                y[-1, -1, -1] ^= 2
                return y
        monkeypatch.setattr(program, "RnsNTT", Altered)


@pytest.mark.parametrize("fault,cell,number", [
    ("state_unchanged", "tiny-mult", "relin_mismatch"),
    ("half_the_batch", "tiny-ntt", "fwd_mismatch"),
    ("altered_product", "tiny-mult", "prod_mismatch"),
    ("altered_inverse", "tiny-ntt", "inv_mismatch"),
])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault, cell,
                                            number):
    import hexl_tpu_torch as program

    getattr(Fault, fault)(program, monkeypatch)
    result, checks, _ = run(tiny, cell)
    assert not result["correct"]
    assert result["failed"] > 0
    assert checks[number]["value"] > checks[number]["limit"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    script = textwrap.dedent(f"""
        import sys, time, json, torch
        sys.path.insert(0, {str(ROOT)!r})
        from hebench import harness, registry
        from hebench.tests import conftest
        import pathlib
        reg = conftest.make_tiny(pathlib.Path({str(tmp_path)!r}))
        r, _, _ = harness.run_cell(reg, "tiny-mult", 5, 0.2, False,
                                   torch.device("cpu"), time.perf_counter())
        import hebench.reference
        print(json.dumps({{"correct": r["correct"],
                           "found": harness.forbidden_modules(),
                           "program": "hexl_tpu_torch" in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": [], "program": True}


@pytest.mark.parametrize("path", sorted((ROOT / "hebench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for name in names:
            assert name.split(".")[0] not in harness.FORBIDDEN, name


def test_the_reference_loads_nothing_of_the_program():
    script = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {str(ROOT)!r})
        from hebench import reference as ref
        t = ref.Tables(8, [17])
        ref.inverse(ref.forward(torch.ones(1, 1, 8, dtype=torch.int64), t), t)
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"hexl_tpu", "hexl_tpu_torch", "jax", "jaxlib"}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hexl_tpu_torch_like", object())
    assert "hexl_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hexl_tpu.fake", object())
    assert "hexl_tpu.fake" in harness.forbidden_modules()


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "hebench/run.py", "--workload",
         "n32768-mult-stream", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.gpu
def test_the_first_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "hebench/run.py", "--workload",
         "n32768-mult-stream", "--seed", str(2**31 + 9), "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, timeout=1200,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
