"""deplex_tpu_torch.tools on the CPU at small sizes: ``apply_labels`` and
the dataset readers against the reference package's scripts (loaded by
path), and the benches (``stage_bench``, ``bench_720p``, ``spatial_bench``,
``scaling_report``) through their ``main`` with ``--device cpu``: report
keys, exit code, and nothing written under ``data/``. The card runs them at
full size (chip_smoke.py)."""

import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu_torch.parallel.verify import synth_depth, synth_intrinsics
from deplex_tpu_torch.tools import (apply_labels, bench_720p, scaling_report, spatial_bench,
                                    stage_bench)
from deplex_tpu_torch.tools.readers import IclReader, TumReader
from deplex_tpu_torch.utils.depth_image import write_png16

from .conftest import DATA

ROOT = DATA.parent


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _load_script(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _data_listing() -> dict:
    return {str(p): p.stat().st_mtime_ns for p in DATA.rglob("*")}


@pytest.fixture(scope="module")
def small_frame(tmp_path_factory):
    """A 48x64 frame of two tilted walls as a PNG, and its intrinsics file."""
    d = tmp_path_factory.mktemp("small")
    write_png16(d / "f.png", synth_depth(1)[0])
    np.savetxt(d / "f.K", synth_intrinsics())
    return d / "f.png", d / "f.K"


def test_apply_labels_colours_equal_the_scripts(tmp_path, capsys):
    script = _load_script("jax_apply_labels", ROOT / "scripts" / "apply_labels.py")
    rng = np.random.default_rng(3)
    points = rng.normal(size=(200, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 200)
    for seed in (0, 5):
        np.testing.assert_array_equal(apply_labels.colorize(points, labels, seed),
                                      script.colorize(points, labels, seed))
    assert (apply_labels.colorize(points, labels)[labels == 0] == 0).all()
    cloud, lab, out = tmp_path / "cloud.csv", tmp_path / "labels.csv", tmp_path / "out.csv"
    np.savetxt(cloud, points, delimiter=",", fmt="%g")
    np.savetxt(lab, labels, fmt="%d")
    assert apply_labels.main([str(cloud), str(lab), "--out", str(out)]) == 0
    rows = np.loadtxt(out, delimiter=",")
    assert rows.shape == (200, 6)
    np.testing.assert_allclose(rows[:, 3:], script.colorize(points, labels), rtol=1e-5)
    assert "planes" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["tum", "icl"])
def test_readers_yield_the_scripts_clouds(kind, tmp_path):
    script = _load_script(f"jax_{kind}_reader", ROOT / "scripts" / "readers" /
                          f"{kind}_reader.py")
    png = DATA / ("tum/1341848230.910894.png" if kind == "tum" else "icl_nuim/0.png")
    for name in ("2.png", "10.png"):
        shutil.copy(png, tmp_path / name)
    ours, ref = ((TumReader, script.TumReader) if kind == "tum"
                 else (IclReader, script.IclReader))
    got, want = list(ours(str(tmp_path))), list(ref(str(tmp_path)))
    assert len(got) == len(want) == len(ours(str(tmp_path))) == 2
    for (stem, cloud), (ref_stem, ref_cloud) in zip(got, want):
        assert stem == ref_stem
        assert cloud.shape == (480 * 640, 3) and cloud.dtype == np.float32
        np.testing.assert_array_equal(cloud, ref_cloud)
    # Other intrinsics move x and y, never the depth.
    _, cloud = next(iter(ours(str(tmp_path), np.eye(3, dtype=np.float32))))
    np.testing.assert_array_equal(cloud[:, 2], got[0][1][:, 2])


def _run_main(module, argv, capsys) -> dict:
    before = _data_listing()
    assert module.main(argv) == 0
    assert _data_listing() == before, "a tool wrote under data/"
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_stage_bench_reports_every_stage(small_frame, tmp_path, capsys):
    png, K = small_frame
    out = tmp_path / "stages.json"
    report = _run_main(stage_bench, ["--device", "cpu", "--batch", "2", "--ring", "2",
                                     "--repeats", "2", "--image", str(png), "--intrinsics",
                                     str(K), "--out", str(out)], capsys)
    assert set(report["us_per_frame"]) == set(stage_bench.STAGES) | {"whole_path",
                                                                       "whole_path_identical"}
    assert set(report["share_of_stage_sum"]) == set(stage_bench.STAGES)
    assert abs(sum(report["share_of_stage_sum"].values()) - 1) < 1e-3
    assert all(v > 0 for v in report["us_per_frame"].values())
    assert report["device"] == "cpu" and report["gpu"] is None
    assert report["planes_min"] >= 1 and report["frame"] == "64x48"
    assert json.loads(out.read_text()) == report


def test_bench_720p_checks_every_timed_frame(capsys, monkeypatch):
    report = _run_main(bench_720p, ["--device", "cpu", "--batch", "2", "--ring", "2",
                                    "--repeats", "4", "--height", "72", "--width", "128"],
                       capsys)
    for key in ("frames_per_s", "us_per_frame", "timed_calls", "planes_min", "planes_max",
                "labelled_share_min", "ring_bytes", "launches", "gpu", "pass"):
        assert key in report, key
    assert "r4_baseline_fps" not in report and "vs_r4" not in report
    assert report["pass"] and report["timed_calls"] == 2
    assert report["ring_bytes"] == 4 * 72 * 128 * 2
    assert 2 <= report["planes_min"] <= report["planes_max"] <= 16
    # A bound no frame meets fails the run.
    monkeypatch.setattr(bench_720p, "PLANES_MIN", 17)
    assert bench_720p.main(["--device", "cpu", "--batch", "1", "--ring", "1", "--repeats", "1",
                            "--height", "72", "--width", "128"]) == 1


def test_spatial_bench_one_and_two_ranks(capsys):
    report = _run_main(spatial_bench, ["--device", "cpu", "--ranks", "1,2", "--cases", "stress",
                                       "--stress-size", "96x128", "--repeats", "1",
                                       "--timeout", "180"], capsys)
    assert report["pass"]
    rows = {r["ranks"]: r for r in report["rows"]}
    assert set(rows) == {0, 1, 2}
    assert rows[0]["shape"] == "128x96" and rows[0]["patch"] == 8
    for n in (1, 2):
        r = rows[n]
        assert r["backend"] == "gloo" and r["devices"] == ["cpu"] * n
        assert r["labels_equal_single"] == [True] * n and not r["jax_imported"]
        assert len(r["us_per_frame_per_rank"]) == n
        # 12 cell rows of 16 cells, 22 floats a cell, padded to the ranks.
        assert r["gathered_bytes"] == n * -(-12 // n) * 16 * 22 * 4


def test_scaling_report_rows(small_frame, capsys):
    png, K = small_frame
    report = _run_main(scaling_report, ["--device", "cpu", "--ranks", "1,2",
                                        "--frames-per-device", "2", "--repeats", "1",
                                        "--image", str(png), "--intrinsics", str(K),
                                        "--timeout", "180"], capsys)
    assert report["pass"] and report["cards"] == 0 and "host contention" in report["note"]
    assert [r["ranks"] for r in report["rows"]] == [1, 2]
    assert [r["batch"] for r in report["rows"]] == [2, 4]
    for r in report["rows"]:
        assert r["backend"] == "gloo" and r["labels_equal_single"] and r["frames_per_s"] > 0
        assert set(r) >= {"ranks", "backend", "frames_per_s", "scaling_efficiency"}
    assert report["rows"][0]["scaling_efficiency"] == 1.0


def test_tools_refuse_to_run_without_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (stage_bench, bench_720p, spatial_bench, scaling_report):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.run(None)
