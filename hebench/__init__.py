"""hebench: the benchmark of hexl_tpu_torch (the PyTorch and CUDA port).

`python3 hebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on one card and
prints one JSON line. Everything that belongs to one configuration, traffic
mix, operation kind or metric lives in a file of its own, found by name
(`registry.py`); the plain reference that decides `correct` is in
`reference/` and imports nothing of the program.
"""
