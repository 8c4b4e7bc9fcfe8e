"""The comparison that decides `correct`, driven through a whole run of
each cell at a small size on the CPU with the cell's own limits: the
sound program passes, and the result line has the contract's shape; the
control (the reference at the precision below the configuration's, in
the program's place) fails; and so does the program broken underneath
its timed entry, once for each fault a cell can have."""

import json

import pytest
import torch

from sdrbench import system
from sdrbench.tests import small
from supersdr_tpu_torch.runtime import wideband

CELLS = ["hf2560_am_fast.replay", "hf2560_am_quality.replay",
         "hf2560_am_fast.live"]
E2E = {"hf2560_am_fast.replay": {"input_msps", "peak_mem_gib", "setup_s"},
       "hf2560_am_quality.replay": {"input_msps", "input_msps.quality",
                                    "peak_mem_gib", "setup_s"},
       "hf2560_am_fast.live": {"latency_p50_ms", "latency_p95_ms",
                               "peak_mem_gib", "setup_s"}}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_its_line_has_the_contract_shape(cell):
    result, lines = small.execute(small.cell(cell), system.program)
    assert result["correct"], result["compared"]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "compared"]
    # on the CPU a live chunk may well take longer than its air time
    assert 0 <= result["failed"] <= result["attempted"] > 0
    assert set(result["metrics"]) == E2E[cell]
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(result["device"])
    assert set(result["compared"]) == {"audio_err", "planes_err",
                                       "rssi_err_db", "state_err"}
    assert lines[-4:] == [f"compared {n}: {v} limit {lim}"
                          for n, (v, lim) in result["compared"].items()]
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result, _ = small.execute(small.cell(cell), system.Control)
    assert not result["correct"], result["compared"]


def _state_unchanged(real):
    def step(cfg, params, state, iq16):
        return state, real(cfg, params, state, iq16)[1]
    return step


def _half_the_channels(real):
    def step(cfg, params, state, iq16):
        st, out = real(cfg, params, state, iq16)
        audio, rssi = out.audio.clone(), out.rssi.clone()
        audio[:, ::2] = 0.0
        rssi[::2] = -127.0
        return st, out._replace(audio=audio, rssi=rssi)
    return step


def _answer_altered(real):
    def step(cfg, params, state, iq16):
        st, out = real(cfg, params, state, iq16)
        return st, out._replace(audio=out.audio * 2.0)
    return step


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_channels,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(wideband, "process_i16",
                        fault(wideband.process_i16))
    result, _ = small.execute(small.cell(cell), system.program)
    assert not result["correct"], result["compared"]


def test_nan_reads_infinite():
    from sdrbench import check
    r = check.Readings()
    r.add("audio_err", float("nan"))
    assert r.worst["audio_err"] == float("inf")
    t = torch.ones(2, 3)
    assert check.rel_rows(t * float("nan"), t) == float("inf")
