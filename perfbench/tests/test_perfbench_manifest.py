"""BENCHMARK.json against the benchmark's contract: names and units in the
allowed characters, every file it names present, every cell on one chip,
each per-layer metric's `moves` reported in every cell it lists, a reader
for every per-layer metric, and a check budget that fits."""
from __future__ import annotations

import json
import re

import pytest

from _cells import ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["perfbench"]
    assert M["command"][1].startswith("perfbench/") and len(M["command"]) <= 32
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_names_units_and_text_fields():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and ONE_LINE.match(w["why"])
    for c in M["configs"]:
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
    for m in M["per_layer"]:
        assert ONE_LINE.match(m["layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cells_files_and_chips():
    cfgs = {c["name"]: c for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert w["chips"] == 1
        assert w["config"] in cfgs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        data = json.loads((ROOT / "perfbench" / "workloads" / f"{w['name']}.json").read_text())
        assert data["config"] == w["config"] and data["traffic"] == w["traffic"]
        assert data["chips"] == w["chips"] and data["why"] == w["why"]
        assert (ROOT / "perfbench" / "traffic" / f"{data['kind']}.py").exists()
    for c in cfgs.values():
        assert c["file"].startswith("perfbench/configs/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert (ROOT / "perfbench" / "reference" / f"{data['arch']}.py").exists()
    assert all(any(w["config"] == c for w in M["workloads"]) for c in cfgs)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in M["per_layer"])
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_per_layer_metric_moves_a_metric_of_its_cells_and_has_a_reader(metric):
    m = next(x for x in M["per_layer"] if x["name"] == metric)
    moved = next(x for x in M["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell])
    reader = ROOT / "perfbench" / "layer_metrics" / f"{metric}.py"
    assert reader.exists()
    assert "def read(run)" in reader.read_text()
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_check_budget_fits_at_24_cells():
    per_run = M["run_seconds"] + 60
    total = (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_roofline_and_mfu_metrics_are_shares():
    for m in M["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
