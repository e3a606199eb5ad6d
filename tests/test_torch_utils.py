"""The port's utilities against the JAX package's: HEXL_TPU_VLOG logging
(and the eltwise ops' vlog(3) records), the analytic `ntt_cost`, the
torch.profiler `trace`, `prewarm`, and the top-level exports."""

import json
import logging
import os

import numpy as np
import pytest

import hexl_tpu_torch
from hexl_tpu.utils.profiling import ntt_cost as jax_ntt_cost
from hexl_tpu_torch import eltwise_add_mod, nt, prewarm, utils
from hexl_tpu_torch.utils import get_logger, vlog
from hexl_tpu_torch.utils.profiling import ntt_cost, trace


def test_vlog(monkeypatch, caplog):
    """The counterpart of tests/test_utils.py::test_vlog."""
    monkeypatch.setenv("HEXL_TPU_VLOG", "3")
    assert get_logger().name == "hexl_tpu_torch"
    with caplog.at_level(logging.INFO, logger="hexl_tpu_torch"):
        vlog(3, "hello %d", 42)
        vlog(5, "hidden")
    assert any("hello 42" in r.message for r in caplog.records)
    assert not any("hidden" in r.message for r in caplog.records)


@pytest.mark.parametrize("level", ["3", "0", "junk"])
def test_eltwise_ops_vlog_at_level_3(monkeypatch, caplog, level):
    monkeypatch.setenv("HEXL_TPU_VLOG", level)
    q = 769
    a = np.arange(8, dtype=np.uint64)
    with caplog.at_level(logging.INFO, logger="hexl_tpu_torch"):
        eltwise_add_mod(a, a, q, device="cpu")
    records = [r.message for r in caplog.records
               if r.name == "hexl_tpu_torch"]
    assert records == (["eltwise_add_mod q=769"] if level == "3" else [])


def test_utils_reexports():
    assert utils.__all__ == ["check", "check_bounds", "debug_enabled",
                             "get_logger", "vlog"]
    assert utils.check.check_bounds is utils.check_bounds
    assert utils.debug_enabled() in (True, False)


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("q_bits", [20, 29, 30, 50, 60])
def test_ntt_cost_equals_jax(q_bits, approx):
    for log_n in range(1, 21):
        n = 1 << log_n
        assert (ntt_cost(n, q_bits, approx)
                == jax_ntt_cost(n, q_bits, approx))
    assert ntt_cost(1 << 14) == jax_ntt_cost(1 << 14)


def test_trace_on_the_cpu_writes_events(tmp_path):
    import torch
    with trace(str(tmp_path)) as path:
        with torch.profiler.record_function("hexl_tpu_torch.test"):
            eltwise_add_mod(np.arange(64, dtype=np.uint64), 1, 769,
                            device="cpu")
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "hexl_tpu_torch.test" for e in events)


def test_prewarm_populates_and_runs():
    """The counterpart of tests/test_utils.py's prewarm test."""
    recs = prewarm([(64, 30)], batch=1, verbose=False, device="cpu")
    assert [(r[0], r[2]) for r in recs] == [(64, "xla")]
    assert recs[0][3] >= 0
    assert recs[0][1] == nt.generate_primes(1, 30, True, ntt_size=64)[0]


def test_prewarm_backends_and_q_spec(capsys):
    q = nt.generate_primes(1, 40, True, ntt_size=256)[0]
    recs = prewarm([(256, q), (256, 20)], batch=2,
                   backends=("xla", "pallas", "mxu"), device="cpu")
    # A q spec above 2^20 is a modulus, else a bit width.
    q20 = nt.generate_primes(1, 20, True, ntt_size=256)[0]
    assert [(r[0], r[1], r[2]) for r in recs] == [
        (256, q, "xla"), (256, q, "pallas"), (256, q, "mxu"),
        (256, q20, "xla"), (256, q20, "pallas"), (256, q20, "mxu")]
    assert capsys.readouterr().out.count("prewarm: n=2^8") == 6
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        prewarm([(64, 30)], backends=("tpu",), verbose=False, device="cpu")


def test_prewarm_defaults_to_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: prewarm runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        prewarm([(64, 30)], verbose=False)


def test_top_level_exports():
    from hexl_tpu_torch import ref
    assert hexl_tpu_torch.ref is ref and callable(ref.fwd_ntt_radix2)
    assert hexl_tpu_torch.prewarm is prewarm and callable(prewarm)
    assert {"ref", "prewarm", "nt"} <= set(hexl_tpu_torch.__all__)
