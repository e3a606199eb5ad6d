"""The CKKS chain's configuration and its multiply at every level
(`ops/he_mult_levels.py`): the configuration against SEAL's rules, the
roofline as the mean over the cycle, the call's (level, pair) map, and a
tiny chain run through the harness on the CPU, whose check holds the
program against the plain reference, and whose float64 control and a
broken key switch come out as not correct."""

from __future__ import annotations

import collections
import importlib
import json
import time
from types import SimpleNamespace

import pytest
import torch

from hebench import control, harness, registry
from hebench.roofline import he_mult, he_mult_levels
from hebench.tests.conftest import ROOT, seal_primes

CPU = torch.device("cpu")
TINY_N = 32
TINY_BITS = [60, 40, 40, 40, 60]


def test_the_ckks_configuration_follows_seal():
    reg = registry.Registry(registry.load_benchmark(ROOT), ROOT)
    cfg = reg.config("seal-ckks-n32768-d19")
    bits = cfg["coeff_modulus_bits"]
    assert bits == [60] + [40] * 19 + [60]
    assert sum(bits) == 880 <= 881
    # One more 40-bit prime would pass SEAL's MaxBitCount(32768, tc128).
    assert sum(bits) + 40 > 881
    assert cfg["moduli"] == seal_primes(32768, bits)
    assert cfg["key_switch"] == {"decomp_modulus_size": 20,
                                 "key_modulus_size": 21,
                                 "rns_modulus_size": 21,
                                 "key_component_count": 2}
    assert cfg["levels"] == list(range(20, 1, -1))
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    tr = reg.traffic("mult-levels-8")
    assert tr["levels"] == cfg["levels"]
    assert tr["trace_calls"] % len(tr["levels"]) == 0


def test_the_levels_roofline_is_the_mean_over_the_cycle():
    levels = (20, 9, 2)
    got = he_mult_levels.counts(n=1024, levels=levels, kc=2)
    each = [he_mult.counts(1024, d, d + 1, 2) for d in levels]
    for name in ("bytes", "products", "limb_transforms"):
        assert got[name] == pytest.approx(sum(c[name] for c in each) / 3)
    # (d + 1)(d + 2) limb transforms a level.
    assert got["limb_transforms"] == sum((d + 1) * (d + 2)
                                         for d in levels) / 3


def test_call_i_takes_the_levels_in_turn_and_the_pairs_in_turn():
    op = registry.Registry(registry.load_benchmark(ROOT), ROOT) \
        .module("ops", "he_mult_levels")
    st = SimpleNamespace(levels=[4, 3, 2], pool=2)
    assert [op.key(st, i) for i in range(7)] == [
        (4, 0), (3, 0), (2, 0), (4, 1), (3, 1), (2, 1), (4, 0)]


def tiny_chain(tmp_path) -> registry.Registry:
    """BENCHMARK.json plus the cell tiny-levels: the chain {60, 40 x 3, 60}
    at N = 32, multiplies at ds 4 .. 1, 2 in flight, 2 pairs a level."""
    cfg = {"name": "tiny-ckks", "poly_modulus_degree": TINY_N,
           "coeff_modulus_bits": TINY_BITS,
           "moduli": seal_primes(TINY_N, TINY_BITS),
           "key_switch": {"decomp_modulus_size": 4, "key_modulus_size": 5,
                          "rns_modulus_size": 5, "key_component_count": 2},
           "levels": [4, 3, 2, 1]}
    (tmp_path / "tiny-ckks.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "tiny-levels.json").write_text(json.dumps(
        {"op": "he_mult_levels", "in_flight": 2, "levels": [4, 3, 2, 1],
         "pool_per_level": 2, "sample": 6, "trace_calls": 4}))
    bench = registry.load_benchmark(ROOT)
    bench["configs"].append({"name": "tiny-ckks",
                             "file": str(tmp_path / "tiny-ckks.json")})
    bench["workloads"].append({"name": "tiny-levels", "config": "tiny-ckks",
                               "traffic": "tiny-levels", "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] == "he_mult_per_s":
            m["workloads"].append("tiny-levels")
    return registry.Registry(bench, ROOT, dirs=(tmp_path,))


def test_a_tiny_chain_is_correct_at_every_level(tmp_path):
    reg = tiny_chain(tmp_path)
    result, checks, _ = harness.run_cell(reg, "tiny-levels", 2**31 + 11,
                                         0.3, False, CPU,
                                         time.perf_counter())
    assert result["correct"] and result["attempted"] >= 8
    assert set(result["metrics"]) == {"he_mult_per_s", "setup_s"}
    assert set(checks) == {"prod_mismatch", "relin_mismatch"}
    assert all(c["value"] == 0 for c in checks.values())


def test_a_tiny_chain_with_a_broken_switch_is_not_correct(tmp_path,
                                                          monkeypatch):
    import hexl_tpu_torch as program

    real = program.key_switch

    def off_by_one(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0, -1, 0] ^= 1                  # the last prime of the level
        return out
    monkeypatch.setattr(program, "key_switch", off_by_one)
    result, checks, _ = harness.run_cell(tiny_chain(tmp_path), "tiny-levels",
                                         2**31 + 12, 0.3, False, CPU,
                                         time.perf_counter())
    assert not result["correct"] and result["failed"] > 0
    assert checks["relin_mismatch"]["value"] > 0
    assert checks["prod_mismatch"]["value"] == 0


def test_the_control_of_a_tiny_chain_is_not_correct(tmp_path):
    reg = tiny_chain(tmp_path)
    result, checks = control.readings(reg, "tiny-levels", 2**31 + 13, CPU,
                                      0.3)
    assert result["correct"] is False
    assert result["failed"] == min(result["attempted"], 6)
    assert all(c["value"] > c["limit"] for c in checks.values())


def test_ks_capture_s_reads_the_program_counter(monkeypatch):
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    read = registry.Registry(registry.load_benchmark(ROOT), ROOT) \
        .module("metrics", "ks_capture_s.levels").read
    monkeypatch.setattr(ks, "graph_stats", collections.Counter(
        eager=19, captures=19, replays=100, capture_s=2.5,
        pool_bytes=1 << 30))
    assert read(None) == 2.5
    # A program that counts calls but not the captures' seconds (the
    # parent of this counter), or no calls at all: nothing to read.
    monkeypatch.setattr(ks, "graph_stats", collections.Counter(
        eager=1, captures=1, replays=9))
    assert read(None) is None
    monkeypatch.setattr(ks, "graph_stats", collections.Counter())
    assert read(None) is None
    monkeypatch.delattr(ks, "graph_stats")
    assert read(None) is None


def test_the_levels_tool_checks_every_level(tmp_path):
    from hebench import levels

    op, st = levels.setup(tiny_chain(tmp_path), "tiny-levels", 2**31 + 14,
                          CPU)
    assert levels.mismatches(op, st) == {d: [0, 0] for d in (4, 3, 2, 1)}
