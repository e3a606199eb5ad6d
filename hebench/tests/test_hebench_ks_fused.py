"""The reader of `ks_fused_pct.mult`: the key switch's route counter
(`experimental.key_switch.block_stats`) as a share of its stacked card
calls."""

from __future__ import annotations

import collections
import importlib

import pytest

from hebench.tests.conftest import ROOT  # noqa: F401  (puts ROOT on sys.path)


def test_ks_fused_pct_reads_the_program_counter(tiny, monkeypatch):
    ks = importlib.import_module("hexl_tpu_torch.experimental.key_switch")
    read = tiny.module("metrics", "ks_fused_pct.mult").read
    monkeypatch.setattr(ks, "block_stats", collections.Counter(
        fused=999, staged=1))
    assert read(None) == pytest.approx(99.9)
    monkeypatch.setattr(ks, "block_stats", collections.Counter(fused=7))
    assert read(None) == 100.0
    # No stacked call on the card: nothing to read.
    monkeypatch.setattr(ks, "block_stats", collections.Counter())
    assert read(None) is None
    # A program without the counter (the parent of the fused route).
    monkeypatch.delattr(ks, "block_stats")
    assert read(None) is None
