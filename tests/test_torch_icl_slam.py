"""deplex_tpu_torch's PlaneSlam on the ICL-NUIM sequence (BASELINE.json
config 3) against deplex_tpu's: tests/test_slam_sequence.py's half-resolution
ICL sequence (240x320, ``smooth_trajectory(30, seed=1)``, the ICL ini at
P=4, 64 landmarks, 10 odometry iterations), frames fed from memory as the
same uint16 maps the PNGs hold.

Both packages make the same matches and spawns frame by frame. Poses agree
within tests/test_torch_slam_frontend.py's whole-run tolerance while both
extract the same planes. On frame 4 they do not: four planar cells of
this noise-free render carry a normal that is float32 noise (lambda_min at
rounding level), the two packages round it differently in stage 1, and the
growing rounds then run in another order (215 of 4,800 cells differ, not
the same partition). Fed the JAX package's own cell statistics, the port's
stages 2-5 give its labels exactly, so the difference is stage 1's noise,
and neither side is wrong (ROADMAP queue 3); it moves frame 4's pose by
5.8 mm, and frame 5 is back within the tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu import Config as JaxConfig
from deplex_tpu.pipeline import backproject_device as jax_backproject
from deplex_tpu.pipeline import extract_planes_debug as jax_extract_planes_debug
from deplex_tpu.slam import PlaneSlam as JaxPlaneSlam
from deplex_tpu.utils import DepthImage, read_intrinsics
from deplex_tpu.utils.warp import render_sequence, smooth_trajectory
from deplex_tpu_torch import Config, PlaneExtractor, PlaneSlam
from deplex_tpu_torch.interop import cell_stats_from_numpy
from deplex_tpu_torch.ops.growing import grid_of_stats
from deplex_tpu_torch.pipeline import backproject_device, depth_tensor, labels_from_stats

from .conftest import DATA

INI = str(DATA / "configs" / "ICL_living_room.ini")
# tests/test_torch_slam_frontend.py's whole-run tolerance: rotation entries
# and translations (mm).
R_TOL, T_TOL = 1e-4, 0.5
FRAMES = 6
# The frame whose stage-1 noise changes the planes (see above).
STAGE1_NOISE_FRAME = 4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def icl_half_sequence(frames: int):
    """tests/test_slam_sequence.py's icl_sequence, rounded and clipped to
    uint16 as its PNGs are: (frames, K, poses)."""
    img = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    K = np.asarray(read_intrinsics(str(DATA / "configs" / "ICL_living_room.K")), np.float32)
    depth0 = img.data[::2, ::2]
    K2 = K.copy()
    K2[0] *= 0.5
    K2[1] *= 0.5
    poses = smooth_trajectory(30, seed=1)[:frames]
    seq = [np.clip(np.round(d), 0, 65535).astype(np.uint16)
           for d in render_sequence(depth0, K2, poses)]
    return seq, K2, poses


def ate(trajectory, poses) -> float:
    errs = [np.linalg.norm(-R.T @ t - (-Rg.T @ tg)) for (R, t), (Rg, tg) in zip(trajectory, poses)]
    return float(np.sqrt(np.mean(np.square(errs))))


@pytest.fixture(scope="module")
def runs():
    seq, K, _ = icl_half_sequence(FRAMES)
    H, W = seq[0].shape
    ours = PlaneSlam(H, W, Config.from_ini(INI), max_landmarks=64, odom_iterations=10,
                     device="cpu")
    ref = JaxPlaneSlam(H, W, JaxConfig.from_ini(INI), max_landmarks=64, odom_iterations=10)
    counts, ref_counts = [], []
    for d in seq:
        a = ours.process_frame(backproject_device(depth_tensor(d, "cpu"), torch.as_tensor(K)))
        b = ref.process_frame(jax_backproject(jnp.asarray(d), jnp.asarray(K)))
        counts.append((int(a.num_matched), int(a.num_new)))
        ref_counts.append((int(b.num_matched), int(b.num_new)))
    return seq, K, ours, ref, counts, ref_counts


def _pose_diff(a, b):
    return float(np.abs(a[0] - b[0]).max()), float(np.abs(a[1] - b[1]).max())


def extractor_planar(depth, K, H, W, cfg) -> np.ndarray:
    """The port's stage-1 planar mask of one frame (equal to the JAX
    package's: the noise moves normals, not the planarity gates)."""
    from deplex_tpu_torch.pipeline import extract_planes_debug

    pts = backproject_device(depth_tensor(depth, "cpu"), torch.as_tensor(K))
    return extract_planes_debug(pts, image_height=H, image_width=W,
                                config=cfg)["stats"].planar.numpy()


def test_first_frames_match_jax(runs):
    """Frames 0-3: the same matches and spawns, poses within the stated
    tolerance."""
    _, _, ours, ref, counts, ref_counts = runs
    n = STAGE1_NOISE_FRAME
    assert counts[:n] == ref_counts[:n]
    assert all(m > 0 for m, _ in counts[1:n])
    for a, b in zip(ours.trajectory[:n], ref.trajectory[:n], strict=True):
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=R_TOL)
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=T_TOL)


def test_frame_four_differs_only_through_stage_one(runs):
    """Frames 4-5: the same matches and spawns. On frame 4 the two packages'
    planes differ, and only stage 1 makes them differ: the port's stages 2-5
    fed the JAX package's cell statistics give the JAX package's labels.
    Every other frame extracts the same partition, and its pose stays
    within the tolerance (frame 4's is recorded, not bounded)."""
    seq, K, ours, ref, counts, ref_counts = runs
    assert counts == ref_counts
    jcfg, cfg = JaxConfig.from_ini(INI), Config.from_ini(INI)
    H, W = seq[0].shape
    debug = jax.jit(functools.partial(jax_extract_planes_debug, image_height=H, image_width=W,
                                      config=jcfg))
    extractor = PlaneExtractor(H, W, cfg, device="cpu")
    differing = []
    for i, d in enumerate(seq):
        got = extractor.process_depth(d, K)
        jref = debug(jax_backproject(jnp.asarray(d), jnp.asarray(K)))
        pairs = np.unique(np.stack([got, np.asarray(jref["labels"])]), axis=1)
        if not (np.unique(pairs[0]).size == pairs.shape[1] == np.unique(pairs[1]).size):
            differing.append(i)
            stats = cell_stats_from_numpy({k: np.asarray(v) for k, v in
                                           jref["stats"]._asdict().items()}, add_batch_axis=True)
            np.testing.assert_array_equal(labels_from_stats(grid_of_stats(stats, cfg), H, W, cfg)[0].numpy(),
                                          np.asarray(jref["labels"]))
            np.testing.assert_array_equal(np.asarray(jref["stats"].planar),
                                          extractor_planar(d, K, H, W, cfg))
        else:
            dR, dt = _pose_diff(ours.trajectory[i], ref.trajectory[i])
            assert dR <= R_TOL and dt <= T_TOL, (i, dR, dt)
    assert differing == [STAGE1_NOISE_FRAME]


@pytest.mark.slow
def test_icl_sequence_tracking_and_backends():
    """The port's mirror of tests/test_slam_sequence.py's
    test_icl_sequence_tracking_and_backends, with its bounds: 30 frames,
    tracking ATE < 300 mm, BA and pose graph each <= 1.05 x tracking."""
    seq, K, poses = icl_half_sequence(30)
    H, W = seq[0].shape
    slam = PlaneSlam(H, W, Config.from_ini(INI), max_landmarks=64, odom_iterations=10,
                     device="cpu")
    for d in seq:
        slam.process_frame(backproject_device(depth_tensor(d, "cpu"), torch.as_tensor(K)))
    assert len(slam.trajectory) == 30
    ate_track = ate(slam.trajectory, poses)
    assert ate_track < 300.0, ate_track
    tracked = list(slam.trajectory)
    slam.refine(iterations=10)
    ate_ba = ate(slam.trajectory, poses)
    assert ate_ba <= 1.05 * ate_track, (ate_ba, ate_track)
    slam.trajectory = tracked
    slam.optimize_trajectory(min_shared=3)
    ate_pg = ate(slam.trajectory, poses)
    assert ate_pg <= 1.05 * ate_track, (ate_pg, ate_track)
