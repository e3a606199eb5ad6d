"""The control of `correct`: the plain reference computed in float64, the
precision below the exact 64-bit residues the configurations state, put
in the operation's call place and run through the harness's own window,
sample and check, at a cell's own sizes. Its run must come out as not
correct. The benchmark's runs never run it.

    python3 hebench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

prints, for each seed, each number the cell compares beside its limit and
the run's `correct`, and one JSON line of them all. Exits non-zero if the
control of any seed comes out correct.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(reg, cell: str, seed: int, device, seconds: float):
    """(result, checks) of a run of `cell` at `seed` whose calls are the
    float64 reference's: `harness.run_cell` with the call replaced."""
    from hebench import harness
    from hebench.reference import mulmod_f64

    op = reg.module("ops", reg.traffic(reg.workload(cell)["traffic"])["op"])

    def control(st, i):
        return op.reference(st, op.key(st, i), mulmod_f64)

    result, checks, _ = harness.run_cell(reg, cell, seed, seconds, False,
                                         device, time.perf_counter(),
                                         call=control)
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from hebench import registry

    reg = registry.Registry(registry.load_benchmark(ROOT), ROOT)
    out, passed = {}, []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = readings(reg, args.workload, seed,
                                  torch.device("cuda"), args.seconds)
        for name, c in checks.items():
            print(f"control {args.workload} seed {seed}: {name} "
                  f"{c['value']} limit {c['limit']}")
        print(f"control {args.workload} seed {seed}: correct "
              f"{result['correct']}, {result['failed']} of the sampled "
              f"calls failed, {result['attempted']} calls")
        out[seed] = {"correct": result["correct"],
                     "failed": result["failed"],
                     **{k: c["value"] for k, c in checks.items()}}
        if result["correct"]:
            passed.append(seed)
    print(json.dumps({"workload": args.workload, "control": out}))
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
