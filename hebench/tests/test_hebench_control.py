"""The control of `correct`, kept at a size a test run holds: the plain
reference in float64, put in the program's place and run through the
harness's own window and check, comes out as not correct in every cell,
with every sampled call failed."""

from __future__ import annotations

import pytest
import torch

from hebench import control


@pytest.mark.parametrize("cell", ["tiny-mult", "tiny-ntt"])
def test_the_control_is_not_correct(tiny, cell):
    result, checks = control.readings(tiny, cell, 2**31 + 3,
                                      torch.device("cpu"), 0.3)
    assert result["correct"] is False
    assert result["failed"] == min(result["attempted"],
                                   tiny.traffic(cell)["sample"])
    assert all(c["value"] > c["limit"] for c in checks.values())
