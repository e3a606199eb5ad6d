"""ks_graph_pct.mult: the share of the key switch's calls on the card that
replayed the captured graph of its chain, in %:
`hexl_tpu_torch.experimental.key_switch.graph_stats` (`eager`, `captures`,
`replays`), read at the end of the run, warm-up included. Nothing where
the program keeps no such counter or made no call on the card."""

import importlib


def read(run):
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    stats = getattr(ks, "graph_stats", None)
    if stats is None:
        return None
    calls = stats["eager"] + stats["captures"] + stats["replays"]
    if calls == 0:
        return None
    return 100.0 * stats["replays"] / calls
