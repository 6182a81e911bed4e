"""BENCHMARK.json against the benchmark's contract, and every cell found by
name: its configuration, mix, driver, judge and metric readers; a cell
added as new files only."""

import json
import math
import re
import shutil

import numpy as np
import pytest
import torch

from benchmark import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("patchSize",)         # a cell's size: never in `reduced`


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    used = set()
    for w in SPEC["workloads"]:
        cell = harness.resolve(w["name"])
        used.add(w["config"])
        mine = [m["name"] for m in cell.metrics("end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2
        assert cell.metrics("per_layer")
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        reporting = e2e[m["moves"]].get("workloads", [w["name"] for w in SPEC["workloads"]])
        assert set(m["workloads"]) <= set(reporting)


def test_every_name_resolves_to_its_files():
    for w in SPEC["workloads"]:
        cell = harness.resolve(w["name"])
        assert cell.frame.shape == (cell.height, cell.width)
        assert harness.driver_class(cell).__name__ == "Driver"
        kind = cell.config.get("judge", "labels")
        assert cell.judge.__file__ == str(ROOT / "benchmark" / "judges" / f"{kind}.py")
        assert callable(cell.judge.judge) and callable(cell.judge.in_place_of_program)
        for m in cell.metrics("end_to_end") + cell.metrics("per_layer"):
            assert callable(harness.reader(m["name"]))


def test_a_full_check_fits_its_time_at_24_cells():
    per_run = SPEC["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name,ini", [("tum_default", "TUM_fr3_long_val.ini"),
                                      ("tum_ransac", "TUM_fr3_long_val_ransac.ini")])
def test_configurations_are_the_shipped_ini_and_camera(name, ini):
    from deplex_tpu_torch.config import Config

    from benchmark.reference.config import Config as ReferenceConfig

    conf = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    shipped = Config.from_ini(str(ROOT / "data" / "configs" / ini))
    assert Config.from_dict(conf["parameters"]) == shipped
    assert ReferenceConfig.from_dict(conf["parameters"]).__dict__ == shipped.__dict__
    K = np.loadtxt(ROOT / "data" / "configs" / "TUM_fr3_long_val.K", dtype=np.float32)
    assert np.array_equal(np.asarray(conf["intrinsics"], np.float32).reshape(3, 3), K)
    assert conf["reduced"] == [] and not set(conf["reduced"]) & set(WIDTHS)


def _copy_tree(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "data").symlink_to(ROOT / "data")
    return root


def test_a_cell_added_as_new_files_only_is_found_and_runs(tmp_path):
    """A new configuration, mix, per-layer metric and cell: new files and new
    entries in BENCHMARK.json, no existing file edited; the cell resolves,
    runs (on the CPU, at a tiny size) and reports the new metric."""
    root = _copy_tree(tmp_path)
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*.py")}
    conf = json.loads((root / "benchmark/configs/tum_default.json").read_text())
    conf["name"] = "tum_half_cells"
    conf["parameters"] = dict(conf["parameters"], patchSize=20)
    (root / "benchmark/configs/tum_half_cells.json").write_text(json.dumps(conf))
    (root / "benchmark/traffic/resident_b1.json").write_text(json.dumps(
        {"driver": "resident", "batch": 1, "ring_batches": 2, "sample_calls": 1,
         "trace_calls": 2}))
    (root / "benchmark/metrics/calls_per_s.resident.py").write_text(
        "def read(run):\n    return run.window['calls'] / run.window['seconds']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tum_half_cells", "source": "https://example.org/x",
                            "file": "benchmark/configs/tum_half_cells.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tum_half_cells.resident_b1", "config": "tum_half_cells",
                              "traffic": "resident_b1", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "calls_per_s.resident", "unit": "calls/s",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["tum_half_cells.resident_b1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve("tum_half_cells.resident_b1", root=root)
    assert cell.program_config().patch_size == 20
    out = harness.run(cell, 5, 0.2, False, torch.device("cpu"), 0.0, root=root,
                      log=lambda *a: None)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "calls_per_s.resident"}
    assert out["metrics"]["calls_per_s.resident"]["value"] > 0
    after = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*.py")
             if p.relative_to(root) in before}
    assert after == before
    assert math.isfinite(out["metrics"]["setup_s"]["value"])
