"""Run one cell of BENCHMARK.json once, on the card this process finds.

    python3 hebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON object as the last line of standard output (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`: each number compared with its limit), and
the same checks as the last lines of standard error. Exits non-zero,
printing no result, without the CUDA devices the cell asks for, or if JAX
or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def power_note() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"
    return f"nvidia-smi: {out}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # The program's debug checks copy every operand to the host.
    os.environ.pop("HEXL_TPU_DEBUG", None)
    sys.path.insert(0, str(ROOT))
    from hebench import harness, registry

    reg = registry.Registry(registry.load_benchmark(ROOT), ROOT)
    entry = reg.workload(args.workload)
    import torch

    t_torch = time.perf_counter() - T_START
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"hebench: cell {args.workload} needs {chips} CUDA device(s), "
              f"found {found}; no result", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result, checks, notes = harness.run_cell(
        reg, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"hebench: modules of JAX or the JAX package were loaded: "
              f"{found}; no result", file=sys.stderr)
        return 4
    notes.insert(1, f"torch imported at {t_torch:.3f} s from start")
    for line in notes + [power_note()]:
        print(f"hebench: {line}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
