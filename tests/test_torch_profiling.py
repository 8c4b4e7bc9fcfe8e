"""The port's `utils/profiling`: `BlockTimer` and `ThroughputMeter` (the
reference's, copied) give the reference's statistics on the same samples,
and `trace` — `torch.profiler` where the reference has `jax.profiler` —
writes a Chrome trace into its log directory on the CPU."""

import json
import os

import numpy as np
import torch

from supersdr_tpu.utils import profiling as jprof
from supersdr_tpu_torch.utils import profiling


def test_block_timer_and_meter():
    bt = profiling.BlockTimer()
    for _ in range(5):
        with bt.stage("demod"):
            sum(range(1000))
    st = bt.stats("demod")
    assert st["n"] == 5 and st["mean_ms"] >= 0
    assert "demod" in bt.report()
    assert bt.stats("absent") == {"n": 0}

    tm = profiling.ThroughputMeter()
    tm.update(1000)
    import time
    time.sleep(0.01)
    rate = tm.update(1000)
    assert rate > 0


def test_block_timer_matches_the_reference():
    """The same samples give the same stats and report, and the window
    keeps the newest samples in both."""
    samples = np.random.default_rng(0).exponential(0.004, 700)
    port, ref = profiling.BlockTimer(window=512), jprof.BlockTimer(window=512)
    for s in samples:
        port.add("step", float(s))
        ref.add("step", float(s))
    port.add("sink", 0.001)
    ref.add("sink", 0.001)
    assert port.stats("step") == ref.stats("step")
    assert port.stats("step")["n"] == 512
    assert port.report() == ref.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with profiling.trace(logdir) as d:
        y = torch.fft.fft(x @ x)
    assert d == logdir
    files = profiling.trace_files(logdir)
    assert len(files) == 1 and os.path.dirname(files[0]) == logdir
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "aten::mm" in names and any("fft" in n for n in names)
    assert torch.isfinite(y.abs()).all()


def test_trace_defaults_under_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    with profiling.trace() as d:
        torch.ones(4).sum()
    assert d == os.path.join(str(tmp_path), "supersdr_tpu_torch_trace")
    assert len(profiling.trace_files(d)) == 1


def test_get_logger_is_configured_once():
    a = profiling.get_logger("supersdr_tpu_torch_test")
    b = profiling.get_logger("supersdr_tpu_torch_test")
    assert a is b and len(a.handlers) == 1
