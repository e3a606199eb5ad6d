"""The least time of an operation, from its shapes alone: the larger of
its bytes (each input of each public call read once, each output written
once) over the card's HBM rate, and its 64-bit modular products at
`imads_per_product` IMADs each over the card's IMAD rate (`peaks.json`).
Each operation kind's counts are `roofline/<op>.py::counts`."""

from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).parent / "peaks.json")
                   .read_text())


def least_time(counts: dict, device_kind: str):
    """(seconds, "bytes" or "operations") for `counts` ({"bytes",
    "products"}) on the card `device_kind`; None for a card the table
    lacks."""
    dev = PEAKS["devices"].get(device_kind)
    if dev is None:
        return None
    t_bytes = counts["bytes"] / dev["hbm_bytes_per_s"]
    imad_rate = dev["sms"] * dev["imads_per_sm_per_clock"] * dev["sm_clock_hz"]
    t_ops = counts["products"] * PEAKS["imads_per_product"] / imad_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
