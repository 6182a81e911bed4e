"""The benchmark's SLAM deployment (``benchmark/configs/slam_tum.json``:
deplex's TUM ini, 640x480, a 128-landmark map, 8 odometry iterations)
through the port's ``PlaneSlam`` on the CPU twins: over the first 5 frames
of two warped sequences its matches, spawns and map count equal the
benchmark's plain SLAM reference and its poses lie within the judge's
limits; the benchmark's sequence generator gives the port's frames; and
``process_frame``'s host counters (``profiling.slam_counters``) and spans
(``slam.step``, ``slam.download``, the depth's ``io.upload``)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import frames, sequence
from benchmark.judges import slam as judge
from benchmark.reference import slam as reference
from benchmark.reference.config import Config as ReferenceConfig
from deplex_tpu_torch import PlaneSlam, profiling
from deplex_tpu_torch.config import Config
from deplex_tpu_torch.pipeline import backproject_device, depth_tensor
from deplex_tpu_torch.tools.make_sequence import sequence_frames

from .conftest import DATA

CONF = json.loads((DATA.parent / "benchmark" / "configs" / "slam_tum.json").read_text())
SLAM = CONF["slam"]
H, W = CONF["image_height"], CONF["image_width"]
K = np.asarray(CONF["intrinsics"], np.float32).reshape(3, 3)
SEEDS = sequence.sequence_seeds(2 ** 31 + 5, 2)
FRAMES = 5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def depth0():
    return frames.read_png16(DATA.parent / CONF["frame"])


@pytest.fixture(scope="module")
def sequences(depth0):
    return {s: sequence.sequence_frames(depth0, K, FRAMES, s)[0] for s in SEEDS}


def tracker() -> PlaneSlam:
    return PlaneSlam(H, W, Config.from_dict(CONF["parameters"]),
                     max_landmarks=SLAM["max_landmarks"],
                     odom_iterations=SLAM["odom_iterations"],
                     min_obs_weight=SLAM["min_obs_weight"], device="cpu")


def step(slam: PlaneSlam, depth: np.ndarray):
    return slam.process_frame(backproject_device(depth_tensor(depth, "cpu"), torch.as_tensor(K)))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_tracks_as_the_plain_reference(sequences, seed):
    seq = sequences[seed]
    slam = tracker()
    got = [step(slam, d) for d in seq]
    depth = torch.from_numpy(np.stack(seq).view(np.int16)).view(torch.uint16)
    want, ref_map = reference.track(depth, torch.as_tensor(K),
                                    ReferenceConfig.from_dict(CONF["parameters"]),
                                    max_landmarks=SLAM["max_landmarks"],
                                    odom_iterations=SLAM["odom_iterations"],
                                    min_obs_weight=SLAM["min_obs_weight"])
    assert len(want) == FRAMES
    for i, (g, r) in enumerate(zip(got, want)):
        assert torch.equal(g.matches_lm, r.matches_lm), i
        assert int(g.num_matched) == int(r.num_matched) and int(g.num_new) == int(r.num_new)
        assert judge.rotation_error(g.R, r.R) <= judge.ROT_LIMIT_RAD
        assert float(torch.linalg.vector_norm(g.t.double() - r.t.double())) \
            <= judge.TRANS_LIMIT_MM
        assert (int(g.num_matched) > 0) == (i > 0)        # the sequence tracks
    assert int(slam.map.count) == int(ref_map.count) > 0


def test_the_benchmarks_sequence_is_the_ports(depth0):
    got, got_poses = sequence.sequence_frames(depth0, K, 3, SEEDS[0])
    want, want_poses = sequence_frames(depth0, K, 3, SEEDS[0])
    assert len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(a.dtype == np.uint16 for a in got)
    for (Ra, ta), (Rb, tb) in zip(got_poses, want_poses):
        assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb)
    assert sequence.sequence_seeds(7, 4) == sequence.sequence_seeds(7, 4)
    assert len(set(sequence.sequence_seeds(2 ** 31 + 9, 4))) == 4


def test_slam_counters_count_frames_matches_and_host_reads(sequences):
    seq = sequences[SEEDS[0]]
    slam = tracker()
    profiling.reset_slam_counters()
    assert profiling.slam_counters() == {"slam_frames": 0, "slam_matched": 0,
                                         "slam_host_reads": 0}
    matched = 0
    for n, d in enumerate(seq[:3], start=1):
        matched += int(step(slam, d).num_matched)
        assert profiling.slam_counters() == {"slam_frames": n, "slam_matched": matched,
                                             "slam_host_reads": 6 * n}
    assert matched > 0
    profiling.reset_slam_counters()
    assert profiling.slam_counters() == {"slam_frames": 0, "slam_matched": 0,
                                         "slam_host_reads": 0}


def test_process_frames_spans_appear_under_the_profiler(sequences):
    seq = sequences[SEEDS[0]]
    slam = tracker()
    step(slam, seq[0])
    with torch.profiler.profile() as prof:
        with torch.profiler.record_function("call"):
            step(slam, seq[1])
    names = [e.name for e in prof.events()]
    for span in ("io.upload", "slam.step", "slam.download"):
        assert names.count(span) == 1, span
    by = {e.name: e for e in prof.events()}
    assert by["slam.step"].cpu_parent.name == "call"
    assert by["slam.download"].cpu_parent.name == "call"
    assert by["slam.download"].time_range.start >= by["slam.step"].time_range.end
