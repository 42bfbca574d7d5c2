"""The benchmark's files: every cell, configuration, mix and metric that
``BENCHMARK.json`` names is found by its name, agrees with its entry, and
keeps to the allowed characters; a new cell, configuration, mix and metric
are found from their files alone."""
import json
import os
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.spec(ROOT)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(entry):
    cell = harness.find(ROOT, "workloads", entry["name"])
    assert {k: cell[k] for k in entry} == entry
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and _line(entry["why"])
    for key in ("name", "config", "traffic"):
        assert NAME.match(entry[key]), entry[key]
    harness.find(ROOT, "configs", entry["config"])
    mix = harness.find(ROOT, "traffic", entry["traffic"])
    assert hasattr(harness.loop(mix), "Session")
    # a limit for every number the comparison reads, none below 0
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    e2e = {m["name"] for m in harness.end_to_end(BENCH, entry["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer(BENCH, entry["name"])


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"]) and entry["reduced"] == []
    cfg = harness.find(ROOT, "configs", entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["end_to_end"]
                              + BENCH["per_layer"]])
def test_metric_names_and_units(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", [])) <= cells
    if "bound" in entry:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert _line(entry["layer"])
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if entry["name"].endswith("_roofline") or "_roofline." in \
                entry["name"]:
            assert entry["unit"] == "%"


@pytest.mark.parametrize("entry", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_found_by_name(entry):
    assert harness.find(ROOT, "metrics", entry["name"]) == entry
    assert callable(harness.reader(ROOT, entry["name"]))


def test_new_cell_config_mix_and_metric_found_from_files(tmp_path):
    """A later change adds a cell by adding files: the harness finds the
    cell, its configuration, its mix and a new metric, and selects the
    metric for the cell, with no edit of any file it had."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "style1_ric.json").read_text())
    (b / "configs" / "style1_wide.json").write_text(json.dumps(
        {**cfg, "name": "style1_wide", "frame_size": 1024}))
    (b / "traffic" / "serve_long.json").write_text(json.dumps(
        {"name": "serve_long", "loop": "serve_loop", "distinct_frames": 8,
         "warmup_frames": 1, "checked_frames": 4, "traced_units": 4}))
    (b / "workloads" / "style1_wide.serve_long.json").write_text(json.dumps(
        {"name": "style1_wide.serve_long", "config": "style1_wide",
         "traffic": "serve_long", "chips": 1, "why": "a test cell",
         "limits": {"rgb_max_lsb": 1}}))
    metric = {"name": "frames_traced.serve", "unit": "frames",
              "better": "higher", "source": "device_trace",
              "layer": "frame serving", "moves": "images_per_s",
              "workloads": ["style1_wide.serve_long"]}
    (b / "metrics" / "frames_traced.serve.json").write_text(
        json.dumps(metric))
    (b / "metrics" / "frames_traced.serve.py").write_text(
        "def read(ctx):\n    return ctx['trace']['units']\n")
    bench["per_layer"].append(metric)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell(str(root), "style1_wide.serve_long")
    assert cell.config["frame_size"] == 1024
    assert cell.mix["distinct_frames"] == 8
    assert cell.loop.UNIT == "frame"
    chosen = harness.per_layer(harness.spec(str(root)),
                               "style1_wide.serve_long")
    assert [m["name"] for m in chosen] == ["frames_traced.serve"]
    assert harness.reader(str(root), "frames_traced.serve")(
        {"trace": {"units": 4}}) == 4
    with pytest.raises(FileNotFoundError):
        harness.find(str(root), "workloads", "no_such.cell")
    with pytest.raises(ValueError):
        harness.find(str(root), "configs", "../configs/style1_ric")


def test_no_file_outside_the_allowed_names():
    """Files under benchmark/ are named from a name's characters and /."""
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "benchmark")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
