"""BENCHMARK.json against the benchmark's contract: names, units and
lengths; every cell, configuration, traffic mix and metric found as a
file by its name; a new cell picked up from new files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in manifest["workloads"]
              for k in ("config", "traffic")]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in manifest[group]]
        assert len(got) == len(set(got)), group
    for text in [c["why"] for c in manifest["configs"]] + \
            [w["why"] for w in manifest["workloads"]] + \
            [m["layer"] for m in manifest["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    for cell in cells:
        e2e = harness.metric_names(manifest, cell, False)
        layer = harness.metric_names(manifest, cell, True)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert layer
        moved = {m["name"] for m in e2e}
        for m in layer:
            assert m["moves"] in moved, (cell, m["name"])


def test_files_found_by_name(manifest):
    for c in manifest["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for kind in ("families", "reference"):
            assert (BENCH / kind / f"{cfg['family']}.py").is_file()
    for w in manifest["workloads"]:
        cell = harness.cell_files(manifest, w["name"])
        assert cell["workload"]["chips"] == w["chips"] == 1
        assert Path(cell["mix"]["words_path"]).is_file()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_new_workload_needs_new_files_only(manifest, tmp_path):
    """A cell added as a manifest entry plus its own files (here a second
    traffic mix of sd15) is found without editing any file there is."""
    data = tmp_path / "benchmark"
    shutil.copytree(BENCH, data, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    mix = json.loads((data / "traffic" / "c16-512.json").read_text())
    mix["clients"] = 4
    (data / "traffic" / "c4-512.json").write_text(json.dumps(mix))
    wl = json.loads((data / "workloads" / "sd15-512.c16.json").read_text())
    wl.update(traffic="c4-512", why="four clients")
    (data / "workloads" / "sd15-512.c4.json").write_text(json.dumps(wl))
    before = {p: p.read_bytes() for p in data.rglob("*") if p.is_file()
              and p.name not in ("c4-512.json", "sd15-512.c4.json")}
    grown = json.loads(json.dumps(manifest))
    grown["workloads"].append({"name": "sd15-512.c4", "config": "sd15",
                               "traffic": "c4-512", "chips": 1,
                               "why": "four clients"})
    cell = harness.cell_files(grown, "sd15-512.c4", data=data)
    assert cell["mix"]["clients"] == 4
    assert cell["config"]["name"] == "sd15"
    assert {p: p.read_bytes() for p in before} == before


def test_open_loop_traffic_is_refused(manifest, tmp_path):
    """The harness drives closed-loop clients only: a mix that asks for
    another loop stops the run instead of running closed-loop silently."""
    data = tmp_path / "benchmark"
    shutil.copytree(BENCH, data, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    mix = json.loads((data / "traffic" / "c16-512.json").read_text())
    mix["loop"] = "open"
    (data / "traffic" / "c16-512.json").write_text(json.dumps(mix))
    with pytest.raises(harness.RunError, match="closed-loop"):
        harness.cell_files(manifest, "sd15-512.c16", data=data)
