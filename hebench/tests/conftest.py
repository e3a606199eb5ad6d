"""Fixtures of the benchmark's own tests: a tiny configuration and
traffic mixes written as data files into a temporary folder, and a
registry that finds them beside the committed ones."""

from __future__ import annotations

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hebench import registry  # noqa: E402

TINY_N = 32
TINY_BITS = [40, 40, 40, 41]


def seal_primes(n: int, bits) -> list:
    """SEAL's CoeffModulus::Create rule: the largest primes of each bit
    size that are 1 mod 2N, descending, in the order of the sizes."""
    found = {}
    for b in sorted(set(bits)):
        v, got = (1 << b) + 1 - 2 * n, []
        while len(got) < bits.count(b):
            if registry.is_prime(v):
                got.append(v)
            v -= 2 * n
        found[b] = got
    return [found[b].pop(0) for b in bits]


def make_tiny(tmp_path: pathlib.Path) -> registry.Registry:
    """A registry holding BENCHMARK.json plus the data-only cells
    tiny-mult (2 in flight), tiny-latency (1 in flight) and
    tiny-ntt, all on the configuration `tiny`."""
    cfg = {"name": "tiny", "poly_modulus_degree": TINY_N,
           "coeff_modulus_bits": TINY_BITS,
           "moduli": seal_primes(TINY_N, TINY_BITS),
           "key_switch": {"decomp_modulus_size": 3, "key_modulus_size": 4,
                          "rns_modulus_size": 4, "key_component_count": 2}}
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    traffic = tmp_path / "traffic"
    traffic.mkdir()
    mixes = {
        "tiny-mult": {"op": "he_mult", "in_flight": 2, "pool": 3,
                      "sample": 5, "trace_calls": 4},
        "tiny-latency": {"op": "he_mult", "in_flight": 1, "pool": 2,
                         "sample": 3, "trace_calls": 4},
        "tiny-ntt": {"op": "ntt_pair", "in_flight": 2, "pool": 2,
                     "ciphertexts": 2, "sample": 3,
                     "trace_calls": 4}}
    for name, mix in mixes.items():
        (traffic / f"{name}.json").write_text(json.dumps(mix))
    bench = registry.load_benchmark(ROOT)
    bench["configs"].append({"name": "tiny",
                             "file": str(tmp_path / "tiny.json")})
    bench["workloads"] += [{"name": n, "config": "tiny", "traffic": n,
                            "chips": 1} for n in mixes]
    for m in bench["end_to_end"]:
        if m["name"] == "he_mult_per_s":
            m["workloads"] += ["tiny-mult"]
        if m["name"] == "he_mult_p95_ms":
            m["workloads"] += ["tiny-latency"]
        if m["name"] == "ntt_limbs_per_s":
            m["workloads"] += ["tiny-ntt"]
    return registry.Registry(bench, ROOT, dirs=(tmp_path,))


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)
