"""ks_capture_s.levels: the program's host seconds capturing the key
switch's graphs (`hexl_tpu_torch.experimental.key_switch.graph_stats
["capture_s"]`), read at the end of the run: one capture a level, all in
set-up. Nothing where the program keeps no such counter or captured
nothing."""

import importlib


def read(run):
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    stats = getattr(ks, "graph_stats", None)
    if stats is None or "capture_s" not in stats:
        return None
    return stats["capture_s"]
