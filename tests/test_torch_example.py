"""`examples/example_torch.py` end to end on the CPU (the plain versions):
every mini-program checked against `hexl_tpu_torch.ref`."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_example_passes_on_the_cpu():
    # One PyTorch thread: the tier-1 run has six test workers at once
    # (see tests/torch_threads.py).
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "example_torch.py"),
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "All examples passed."
    assert sum(line.startswith("Done running") for line in lines) == 20
