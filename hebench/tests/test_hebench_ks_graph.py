"""The reader of `ks_graph_pct.mult`: the key switch's graph counter
(`experimental.key_switch.graph_stats`) as a share of its card calls."""

from __future__ import annotations

import collections
import importlib

import pytest

from hebench.tests.conftest import ROOT  # noqa: F401  (puts ROOT on sys.path)


def test_ks_graph_pct_reads_the_program_counter(tiny, monkeypatch):
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    read = tiny.module("metrics", "ks_graph_pct.mult").read
    monkeypatch.setattr(ks, "graph_stats", collections.Counter(
        eager=1, captures=1, replays=998))
    assert read(None) == pytest.approx(99.8)
    # No call on the card: nothing to read.
    monkeypatch.setattr(ks, "graph_stats", collections.Counter())
    assert read(None) is None
    # A program without the counter (the parent of the graph path).
    monkeypatch.delattr(ks, "graph_stats")
    assert read(None) is None
