"""deplex_tpu_torch.examples, each driven through its ``main`` with
``--device cpu`` (the plain twins), with the reference examples' output
lines; ``run_slam --dataset`` held frame by frame to the port's PlaneSlam
fed the same frames from memory, and its report to the reference's keys."""

import json
import pathlib

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu_torch import Config, PlaneSlam, native
from deplex_tpu_torch.examples import (extract_primitives, process_cloud, process_sequence,
                                       run_slam)
from deplex_tpu_torch.pipeline import backproject_device, depth_tensor
from deplex_tpu_torch.tools import make_sequence
from deplex_tpu_torch.utils import DepthImage, read_intrinsics

ROOT = pathlib.Path(__file__).resolve().parent.parent
TUM_PNG = str(ROOT / "data/tum/1341848230.910894.png")
TUM_K = str(ROOT / "data/configs/TUM_fr3_long_val.K")
TUM_INI = str(ROOT / "data/configs/TUM_fr3_long_val.ini")
GOLDEN = json.loads((ROOT / "data/golden/slam_ate_tum30.json").read_text())


@pytest.fixture(scope="module")
def seq3(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq3")
    make_sequence.write_sequence(out, TUM_PNG, TUM_K, 3)
    return out


def test_process_cloud_finds_34_planes_on_tum(capsys):
    assert process_cloud.main(["--runs", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Found planes: 34"
    assert out[1].startswith("Elapsed time (mks): ") and out[2].startswith("FPS: ")


@pytest.mark.parametrize("batch", [0, 2])
def test_process_sequence_streams_the_sequence(seq3, batch, capsys):
    native.reset_decode_counts()
    assert process_sequence.main([str(seq3), "--batch", str(batch), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Processed frames: 3"
    assert [ln.split(":")[0] for ln in out[1:]] == [
        "Min elapsed time (mks)", "Max elapsed time (mks)", "Mean elapsed time (mks)", "FPS"]
    # Every frame came through the native loader.
    assert native.decode_counts() == {"native": 3, "python": 0}


@pytest.mark.parametrize("batch", [0, 2])
def test_process_sequence_labels_equal_in_memory_frames(seq3, batch):
    """The decoded PNGs are the written frames' bits, so the labels are the
    in-memory frames' labels."""
    from deplex_tpu_torch import PlaneExtractor

    paths = process_sequence.sequence_paths(seq3)
    K = read_intrinsics(TUM_K)
    cfg = Config.from_ini(TUM_INI)
    out = process_sequence.process_sequence(paths, K, cfg, batch=batch, device="cpu")
    frames, _ = make_sequence.sequence_frames(DepthImage(TUM_PNG).data, K, 3)
    ex = PlaneExtractor(480, 640, cfg, device="cpu")
    assert len(out["labels"]) == 3 and len(out["latency_s"]) == 3
    for got, d in zip(out["labels"], frames):
        np.testing.assert_array_equal(got, ex.process_depth(d, K))


def test_run_slam_dataset_equals_in_memory_tracking(seq3, capsys):
    """The golden's protocol on 3 frames (max_landmarks cut to 32): the same
    per-frame matches, landmarks and tracked poses as a PlaneSlam fed the
    same uint16 frames from memory."""
    native.reset_decode_counts()
    report, tracked, counts = run_slam.run_dataset(run_slam.parse_args(
        ["--dataset", str(seq3), "--config", TUM_INI, "--intrinsics", TUM_K,
         "--max-landmarks", "32", "--frames", "3", "--device", "cpu"]))
    assert native.decode_counts() == {"native": 3, "python": 0}
    K = read_intrinsics(TUM_K)
    frames, _ = make_sequence.sequence_frames(DepthImage(TUM_PNG).data, K, 3)
    ref = PlaneSlam(480, 640, Config.from_ini(TUM_INI), max_landmarks=32, odom_iterations=10,
                    device="cpu")
    ref_counts = []
    for d in frames:
        res = ref.process_frame(backproject_device(depth_tensor(d, "cpu"), torch.as_tensor(K)))
        ref_counts.append((int(res.num_matched), int(res.num_new)))
    assert counts == ref_counts
    for (R, t), (R_ref, t_ref) in zip(tracked, ref.trajectory, strict=True):
        np.testing.assert_array_equal(R, R_ref)
        np.testing.assert_array_equal(t, t_ref)
    assert report["landmarks"] == int(ref.map.count)
    # The report has the golden's keys; its tracking ATE is the in-memory run's.
    assert set(GOLDEN) <= set(report)
    assert report["frames"] == 3 and report["protocol"] == GOLDEN["protocol"]
    assert report["args"]["max_landmarks"] == 32
    gt = np.load(seq3 / "trajectory_gt.npz")
    assert report["ate_rmse_mm"]["tracking"] == run_slam.ate_mm(ref.trajectory, gt["R"], gt["t"])
    assert report["sequence_manifest"]["frames"] == 3
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == report


def test_run_slam_synthetic_room(capsys):
    assert run_slam.main(["--frames", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[:4]] == [f"frame {i:3d}" for i in range(4)]
    assert out[4].startswith("RMS ATE (odometry): ") and out[5].startswith("RMS ATE (after BA): ")


def test_extract_primitives_finds_the_cylinder(capsys):
    assert extract_primitives.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("planes: ") and out[0].endswith("cylinders: 1")
    radius = float(out[1].split("radius=")[1].split("mm")[0])
    assert abs(radius - 400.0) < 32.0
