"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from sdrbench import roofline
from sdrbench.reference import design
from sdrbench import run as R

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SPEC = R.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["sdrbench"]
    assert SPEC["command"][:3] == ["python3", "-m", "sdrbench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in SPEC[group]:
            assert set(e) == keys
            assert NAME.fullmatch(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.fullmatch(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in SPEC["end_to_end"] if R.applies(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(R.applies(m, cell) for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    wl, conf, traffic = R.find_cell(SPEC, cell)
    assert conf["name"] == wl["config"]
    assert (R.BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (R.BENCH / "limits" / f"{cell}.json").is_file()
    assert (R.BENCH / "programs" / f"{conf['program']}.py").is_file()
    mode = conf["deployment"]["mode"].lower()
    assert (R.BENCH / "reference" / "modes" / f"{mode}.py").is_file()
    assert conf["rows"] in design.ROW_ORDERS


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name_and_silent_without_a_trace(metric):
    read = R.metric_reader(metric)
    assert read({"trace": None, "conf": {}, "frames": 0,
                 "dispatch_ms": None}) is None


@pytest.mark.parametrize("kernel", ["channelize_fused", "chain_tail_fir"])
def test_roofline_found_by_name(kernel):
    mod = roofline.kernel(kernel)
    assert mod.KERNEL and callable(mod.counts)
