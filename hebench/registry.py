"""Finds every part of the benchmark by its name.

`BENCHMARK.json` lists the configurations, cells and metrics. A
configuration is the file its entry names; a traffic mix is
`traffic/<name>.json`; the operation a mix drives is `ops/<op>.py`; a
metric's reader is `metrics/<metric name>.py` and an operation's roofline
counts `roofline/<op>.py`. A later cell, mix or metric is added as new
files and entries, never by editing one that is here.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

HEBENCH = pathlib.Path(__file__).resolve().parent
ROOT = HEBENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    witnesses = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)
    for p in witnesses:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for a in witnesses:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def check_config(cfg: dict) -> dict:
    """Refuse a configuration whose primes do not match its own statement:
    each prime, 1 mod 2N, of the stated bit size."""
    n = int(cfg["poly_modulus_degree"])
    moduli = [int(q) for q in cfg["moduli"]]
    bits = [int(b) for b in cfg["coeff_modulus_bits"]]
    if len(moduli) != len(bits) or n < 2 or n & (n - 1):
        raise ValueError(f"{cfg.get('name')}: moduli and bit sizes differ")
    for q, b in zip(moduli, bits):
        if q.bit_length() != b or q % (2 * n) != 1 or not is_prime(q):
            raise ValueError(f"{cfg.get('name')}: {q} is not a {b}-bit "
                             f"prime = 1 mod {2 * n}")
    return cfg


class Registry:
    """The parts of one benchmark. `dirs` are searched in order for
    traffic/, ops/, metrics/ and roofline/ files (this folder last)."""

    def __init__(self, bench: dict, root: pathlib.Path = ROOT,
                 dirs=(HEBENCH,)):
        self.bench = bench
        self.root = pathlib.Path(root)
        self.dirs = [pathlib.Path(d) for d in dirs]
        if HEBENCH not in self.dirs:
            self.dirs.append(HEBENCH)
        self._modules: dict = {}

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def _find(self, kind: str, name: str, suffix: str) -> pathlib.Path:
        if not NAME.match(name):
            raise ValueError(f"bad name {name!r}")
        for d in self.dirs:
            path = d / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(d) for d in self.dirs]}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        with open(self.root / entry["file"]) as f:
            cfg = json.load(f)
        if cfg.get("name") != name:
            raise ValueError(f"{entry['file']} names {cfg.get('name')!r}, "
                             f"not {name!r}")
        return check_config(cfg)

    def traffic(self, name: str) -> dict:
        with open(self._find("traffic", name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        """The module `<kind>/<name>.py` (ops, metrics or roofline)."""
        key = (kind, name)
        if key not in self._modules:
            path = self._find(kind, name, ".py")
            spec = importlib.util.spec_from_file_location(
                f"hebench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a cell reports: its end-to-end metrics with
        `trace` off, its per-layer metrics with it on."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if cell in m.get("workloads", [cell])]
