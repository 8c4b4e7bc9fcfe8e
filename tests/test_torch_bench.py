"""The port's benchmark (`supersdr_tpu_torch.bench`, `cli bench`) on the
CPU: its shapes and knobs are the repository's `bench.py`'s, its SMALL
fixture is what `bench.py`'s JAX-CPU oracle recipe makes, its gates pass
on the CPU and refuse what they must, and the whole flow at a small
headline shape prints every key `bench.py` prints.

The headline here is MID (2560 channels, 512 frames a chunk): the
consistency check compares the headline's first 512 frames with the MID
gate's level, so the channel count stays the headline's.

`PYTHONPATH=. python tests/test_torch_bench.py`, from the repository root,
writes the fixtures (SMALL, and the MID gates' rows) anew."""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from supersdr_tpu_torch import bench
from supersdr_tpu_torch.runtime.wideband import PROFILES

REPO = Path(__file__).resolve().parents[1]
# every key `bench.py`'s main prints for the headline tier, and for the
# other tier's sub-object (plus its own "unit" and "config")
TIER_KEYS = {
    "value", "step_ms", "elapsed_s", "iters", "audio_mean_abs_headline",
    "audio_mean_abs_headline_prefix", "integrity", "i16_ingest",
    *(f"{k}_{g}" for k in ("oracle_snr_db", "audio_mean_abs")
      for g in ("small", "mid", "midssb", "midnbfm"))}
TOP_KEYS = {"metric", "unit", "vs_baseline", "baseline_definition",
            "profile", "config", "quality"}


def _bench_py() -> dict:
    """The constants of the repository's bench.py, read from its source
    (importing it would import the JAX package's profiles)."""
    out = {}
    for node in ast.parse((REPO / "bench.py").read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = eval(
                    compile(ast.Expression(node.value), "bench.py", "eval"),
                    {"dict": dict})
            except NameError:
                pass              # computed from the environment
    return out


def _jax_audio(tmp: Path, src: str, cfg: str, iq: np.ndarray,
               monkeypatch=None) -> np.ndarray:
    """`bench.py`'s oracle source `src` at its config `cfg`, run in this
    process on the JAX CPU backend on `iq`: the audio."""
    ref = _bench_py()
    inp, outp = tmp / "in.npz", tmp / "out.npz"
    np.savez(inp, iq=iq)
    code = ref[src].format(repo=str(REPO), cfg=ref[cfg])
    argv = [sys.argv[0], str(inp), str(outp)]
    if monkeypatch is not None:
        monkeypatch.setattr(sys, "argv", argv)
    else:
        sys.argv = argv
    exec(compile(code, "bench_oracle", "exec"), {})
    return np.load(outp)["audio"]


def _bench_nbfm_input(seed: int) -> tuple:
    """`bench.py`'s own `_nbfm_input`, taken from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_nbfm_input")
    ns = {"np": np, "MID_NBFM": _bench_py()["MID_NBFM"]}
    exec(compile(ast.Module([fn], []), "bench.py", "exec"), ns)
    return ns["_nbfm_input"](seed)


def _jax_small_audio(tmp: Path, monkeypatch=None) -> tuple:
    """`bench.py`'s `_ORACLE_SRC` recipe at SMALL: (seeded input, audio)."""
    iq = bench.noise_input(bench.SMALL, 2, 0)
    return iq, _jax_audio(tmp, "_ORACLE_SRC", "SMALL", iq, monkeypatch)


def _jax_mid_rows(tmp: Path, tag: str, monkeypatch=None) -> tuple:
    """`bench.py`'s oracle recipe for the MID gate `tag`: (seeded input,
    the fixture's channel rows, the audio at those rows)."""
    if tag == "midnbfm":
        iq, rows = _bench_nbfm_input(6)
        audio = _jax_audio(tmp, "_ORACLE_NBFM_SRC", "MID_NBFM", iq,
                           monkeypatch)
    else:
        cfg, seed = {"mid": ("MID", 2), "midssb": ("MID_SSB", 4)}[tag]
        iq = bench.noise_input(_bench_py()[cfg], 1, seed)
        rows = bench.MID_REF_ROWS
        audio = _jax_audio(tmp, "_ORACLE_SRC", cfg, iq, monkeypatch)
    return iq, rows, audio[:, rows, :]


def test_shapes_and_knobs_are_bench_py_s():
    ref = _bench_py()
    for name in ("SMALL", "MID", "MID_SSB", "MID_NBFM", "HEADLINE",
                 "MIN_MEASURE_S"):
        assert getattr(bench, name) == ref[name], name
    assert (bench.PROFILE, bench.N_SCAN) == ("fast", 2)


def test_fixture_is_a_fresh_jax_cpu_run_bit_for_bit(tmp_path, monkeypatch):
    iq, audio = _jax_small_audio(tmp_path, monkeypatch)
    with np.load(bench.SMALL_REF) as d:
        assert str(d["iq_sha256"]) == bench.input_sha256(iq)
        assert d["audio"].dtype == np.float32
        assert d["audio"].shape == (2, 16, 8192)
        np.testing.assert_array_equal(d["audio"], audio)


@pytest.mark.parametrize("tag", ["mid", "midssb", "midnbfm"])
def test_mid_fixture_is_a_fresh_jax_cpu_run_bit_for_bit(tag, tmp_path,
                                                        monkeypatch):
    iq, rows, audio = _jax_mid_rows(tmp_path, tag, monkeypatch)
    with np.load(bench.MID_REF) as d:
        assert str(d[f"{tag}_iq_sha256"]) == bench.input_sha256(iq)
        np.testing.assert_array_equal(d[f"{tag}_rows"], rows)
        assert d[f"{tag}_audio"].dtype == np.float32
        assert d[f"{tag}_audio"].shape == (1, len(rows), 2048)
        np.testing.assert_array_equal(d[f"{tag}_audio"], audio)


def test_the_port_draws_bench_py_s_nbfm_input():
    iq, kbins = bench.nbfm_input(6)
    ref_iq, ref_kbins = _bench_nbfm_input(6)
    np.testing.assert_array_equal(kbins, ref_kbins)
    np.testing.assert_array_equal(iq, ref_iq)


@pytest.mark.parametrize("profile", ["fast", "quality"])
def test_small_gate_passes_on_the_cpu(profile):
    got = bench._gate(PROFILES[profile], bench.SMALL, 2, 0, "small", "cpu",
                      {})
    assert got["ok_small"] and got["oracle_snr_db_small"] >= 50.0
    assert got["audio_mean_abs_small"] > 0


def test_the_input_hash_refuses_another_seed():
    with pytest.raises(RuntimeError, match="draws another sequence"):
        bench._gate(PROFILES["fast"], bench.SMALL, 2, 1, "small", "cpu", {})


def test_a_perturbed_reference_fails_integrity_and_exits_1(monkeypatch,
                                                           capsys):
    """Audio off by −40 dB in the SMALL reference: both tiers fail their
    gate, report value 0, and the run exits 1."""
    real = bench.small_reference

    def perturbed(iq):
        ref = real(iq)
        noise = np.random.default_rng(3).normal(size=ref.shape)
        rms = float(np.sqrt(np.mean(ref ** 2)))
        return ref + (0.01 * rms * noise).astype(np.float32)
    monkeypatch.setattr(bench, "small_reference", perturbed)
    assert bench.main("cpu", bench.MID) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for tier in (line, line["quality"]):
        assert tier["integrity"] == "fail" and tier["value"] == 0.0
        assert tier["oracle_snr_db_small"] < 50.0
        assert tier["oracle_snr_db_mid"] >= 50.0


def test_a_perturbed_mid_fixture_fails_its_gate(monkeypatch):
    """The JAX rows off by −40 dB: the gate fails on them alone, while
    every row still agrees with the port's plain path."""
    real = bench.mid_reference

    def perturbed(tag, iq):
        rows, ref = real(tag, iq)
        noise = np.random.default_rng(3).normal(size=ref.shape)
        rms = float(np.sqrt(np.mean(ref ** 2)))
        return rows, ref + (0.01 * rms * noise).astype(np.float32)
    monkeypatch.setattr(bench, "mid_reference", perturbed)
    got = bench._gate(PROFILES["fast"], bench.MID, 1, 2, "mid", "cpu", {})
    assert not got["ok_mid"]
    assert got["jax_snr_db_mid"] < 50.0 <= got["oracle_snr_db_mid"]


@pytest.mark.parametrize("raised,propagates", [
    (bench.KernelsNotLaunched, True), (RuntimeError, False)])
def test_only_a_launch_fault_ends_the_int16_figure(raised, propagates,
                                                   monkeypatch):
    """A failed int16 figure is an `error` entry; kernels that did not
    launch end the run."""
    def fail(*args):
        raise raised("int16")
    monkeypatch.setattr(bench, "_measure_i16", fail)
    monkeypatch.setattr(bench, "integrity_check", lambda *args: {
        "integrity": "pass", "audio_mean_abs_mid": 1.0})
    monkeypatch.setattr(bench, "consistent", lambda *args: True)
    monkeypatch.setattr(bench, "MIN_MEASURE_S", 0.0)
    monkeypatch.setattr(bench, "N_SCAN", 1)
    if propagates:
        with pytest.raises(raised):
            bench.measure(PROFILES["fast"], "cpu", bench.SMALL)
    else:
        got = bench.measure(PROFILES["fast"], "cpu", bench.SMALL)
        assert got["i16_ingest"] == {"error": "RuntimeError: int16"}


@pytest.mark.parametrize("raised,propagates", [
    (bench.KernelsNotLaunched, True), (RuntimeError, False)])
def test_only_a_launch_fault_ends_the_other_tier(raised, propagates,
                                                 monkeypatch):
    """The other tier's failure is an `error` entry; kernels that did not
    launch end the run."""
    calls = []

    def measure(tuning, device, headline, refs):
        calls.append(tuning)
        if len(calls) == 2:
            raise raised("quality")
        return {"value": 1.0, "integrity": "pass"}
    monkeypatch.setattr(bench, "measure", measure)
    if propagates:
        with pytest.raises(raised):
            bench.results(torch.device("cpu"), bench.SMALL)
    else:
        got = bench.results(torch.device("cpu"), bench.SMALL)
        assert got["quality"] == {"error": "RuntimeError: quality"}
    assert calls == [PROFILES["fast"], PROFILES["quality"]]


@pytest.mark.parametrize("prefix,ok", [(1.0, True), (1.24, True),
                                       (0.76, True), (1.26, False),
                                       (0.74, False)])
def test_consistency_holds_within_25_percent(prefix, ok):
    assert bench.consistent(prefix, 1.0) is ok


@pytest.mark.parametrize("scale,ok", [(1.1, True), (1.4, False)])
def test_a_moved_mid_level_fails_the_headline(scale, ok, monkeypatch):
    """The MID gate's level moved by `scale` against the headline's
    prefix: within 25 % the run times, beyond it integrity fails with
    value 0 and the prefix reported."""
    real = bench.integrity_check

    def moved(tuning, device, refs):
        checks = real(tuning, device, refs)
        return {**checks,
                "audio_mean_abs_mid": checks["audio_mean_abs_mid"] * scale}
    monkeypatch.setattr(bench, "integrity_check", moved)
    monkeypatch.setattr(bench, "MIN_MEASURE_S", 0.0)
    monkeypatch.setattr(bench, "N_SCAN", 1)
    got = bench.measure(PROFILES["fast"], "cpu", bench.MID)
    assert (got["integrity"] == "pass") is ok
    assert (got["value"] > 0) is ok
    assert ("consistency" in got) is not ok
    assert got["audio_mean_abs_headline_prefix"] > 0


def test_measure_prints_every_key_bench_py_prints(monkeypatch, capsys):
    monkeypatch.setattr(bench, "MIN_MEASURE_S", 0.0)
    assert bench.main("cpu", bench.MID) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert TOP_KEYS | TIER_KEYS <= set(line)
    assert {"unit", "config"} | TIER_KEYS <= set(line["quality"])
    assert line["oracle"] == bench.ORACLE
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["config"]["chunk_in"] == bench.MID["chunk_in"]
    assert line["config"]["n_scan"] == 2
    for tier in (line, line["quality"]):
        assert tier["integrity"] == "pass" and tier["value"] > 0
        assert tier["iters"] == 8
        assert min(tier[f"oracle_snr_db_{g}"] for g in (
            "small", "mid", "midssb", "midnbfm")) >= 50.0
        assert min(tier[f"jax_snr_db_{g}"] for g in (
            "mid", "midssb", "midnbfm")) >= 50.0
        assert set(tier["i16_ingest"]) == {"value", "step_ms",
                                           "vs_f32_snr_db"}
        assert tier["i16_ingest"]["vs_f32_snr_db"] > 80.0
    assert line["vs_baseline"] == round(line["value"] / 500.0, 4)


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        iq, audio = _jax_small_audio(Path(tmp))
        mid = {tag: _jax_mid_rows(Path(tmp), tag)
               for tag in ("mid", "midssb", "midnbfm")}
    np.savez(bench.SMALL_REF, audio=audio.astype(np.float32),
             iq_sha256=np.array(bench.input_sha256(iq)))
    print(f"wrote {bench.SMALL_REF}")
    np.savez(bench.MID_REF, **{
        f"{tag}_{k}": v for tag, (iq, rows, audio) in mid.items()
        for k, v in (("iq_sha256", np.array(bench.input_sha256(iq))),
                     ("rows", rows), ("audio", audio.astype(np.float32)))})
    print(f"wrote {bench.MID_REF}")
