"""A chain cell's levels one by one, on the card, outside any timed window:

    python3 hebench/levels.py --workload ckks-n32768-mult-levels --seed <n>

sets the cell's operation up as `run.py` does (so every level's key switch
graph is captured), compares one multiply at every level word for word
with the plain reference, and times each level on the device: the calls
of a level (its whole pool, twice) are queued behind a sleep kernel, so
that the host's pace does not show, and timed with CUDA events. Prints
one JSON line: for each level the mismatched words and the device ms a
multiply, the set-up's seconds, the key switch's graph counters
(`capture_s`, `pool_bytes` and the calls) and each level's pool. Exits
non-zero without a card, or if any level differs from the reference.
"""

import argparse
import contextlib
import importlib
import json
import pathlib
import sys
import time
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent.parent


def setup(reg, cell: str, seed: int, device):
    """The cell's operation module and its set-up state."""
    entry = reg.workload(cell)
    tr = reg.traffic(entry["traffic"])
    op = reg.module("ops", tr["op"])
    st = op.setup(SimpleNamespace(
        config=reg.config(entry["config"]), traffic=tr, seed=seed,
        device=device, span=lambda name: contextlib.nullcontext()))
    return op, st


def mismatches(op, st) -> dict:
    """{level: [mismatched words of each output]} of one call a level (the
    first pair), against the plain reference."""
    out = {}
    for i, d in enumerate(st.levels):
        got = op.call(st, i)
        want = op.reference(st, op.key(st, i))
        out[d] = [int((g != w).sum()) for g, w in zip(got, want)]
    return out


def device_ms(op, st, device, rounds: int = 2) -> dict:
    """{level: device ms a multiply}: each level's pool, `rounds` times,
    queued behind a sleep kernel and timed with CUDA events."""
    import torch

    count = len(st.levels)
    out = {}
    for li, d in enumerate(st.levels):
        calls = [li + count * p for p in range(st.pool)] * rounds
        torch.cuda.synchronize(device)
        torch.cuda._sleep(int(4e7))          # about 20 ms at 1.98 GHz
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for i in calls:
            op.call(st, i)
        end.record()
        end.synchronize()
        out[d] = start.elapsed_time(end) / len(calls)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from hebench import registry

    if not torch.cuda.is_available():
        print("hebench: levels needs a CUDA device; no result",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    reg = registry.Registry(registry.load_benchmark(ROOT), ROOT)
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    t0 = time.perf_counter()
    op, st = setup(reg, args.workload, args.seed, device)
    setup_s = time.perf_counter() - t0
    stats = dict(ks.graph_stats)
    pools = {key[3]: e.pool_bytes for key, e in ks.graphs.items()
             if e is not None}
    words = mismatches(op, st)
    ms = device_ms(op, st, device)
    print(json.dumps({
        "workload": args.workload, "device": torch.cuda.get_device_name(0),
        "setup_s": setup_s, "graph_stats": stats, "pool_bytes": pools,
        "memory_reserved": torch.cuda.memory_reserved(device),
        "levels": {d: {"mismatch": words[d], "device_ms": ms[d]}
                   for d in st.levels}}))
    return 1 if any(any(w) for w in words.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
