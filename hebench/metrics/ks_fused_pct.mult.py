"""ks_fused_pct.mult: the share of the key switch's stacked calls on the
card whose base-conversion block took the fused route (K5.rns.conv and
K10's row map, no staged copy of the block), in %:
`hexl_tpu_torch.experimental.key_switch.block_stats` (`fused`, `staged`),
read at the end of the run, warm-up included. Nothing where the program
keeps no such counter or made no such call on the card."""

import importlib


def read(run):
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    stats = getattr(ks, "block_stats", None)
    if stats is None:
        return None
    calls = stats["fused"] + stats["staged"]
    if calls == 0:
        return None
    return 100.0 * stats["fused"] / calls
