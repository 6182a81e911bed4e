"""deplex_tpu_torch's PlaneSlam vs deplex_tpu's on the synthetic room of
tests/test_slam_frontend.py (120x160, 10 frames, max_landmarks=32).

Stages 1-4 and every SLAM step are held to the JAX package frame by frame,
fed the reference's own state; whole runs must make the same matches, and
the backends (refine, optimize_trajectory) started from the reference's own
checkpoint must land where the reference does. The port's float32 sums and
solves round in another order than XLA's, so plane parameters and poses
agree to stated float32 tolerances, and matches, spawns and counts exactly.

``tests/conftest.py`` fakes 8 CPU devices, so the reference's default
``refine()`` runs keyframe-sharded there; the dense comparison uses
``refine(mesh=False)``.
"""

import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deplex_tpu import Config as JaxConfig
from deplex_tpu.pipeline import backproject_device as jax_backproject
from deplex_tpu.slam import PlaneSlam as JaxPlaneSlam
from deplex_tpu.slam import frontend as jfrontend
from deplex_tpu.utils import warp as jwarp
from deplex_tpu_torch import Config, PlaneSlam
from deplex_tpu_torch.interop import fields_of, map_state_from_numpy, plane_obs_from_numpy
from deplex_tpu_torch.pipeline import backproject_device
from deplex_tpu_torch.slam import frontend
from deplex_tpu_torch.utils import warp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "examples" / "python"))

H, W = 120, 160
K = np.array([[160.0, 0, W / 2 - 0.5], [0, 160.0, H / 2 - 0.5], [0, 0, 1]], np.float32)
ROOM = dict(patch_size=8, max_planes=16, max_region_growing_rounds=32,
            min_region_growing_cells_activated=3, min_region_growing_candidate_size=3,
            depth_discontinuity_threshold=600.0, min_cos_angle_merge=0.97)
# Poses of the port against the reference's: rotation entries and
# translations (mm, the room spans 4000 mm).
R_TOL, T_TOL = 1e-4, 0.5


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def room():
    from run_slam import synthetic_sequence

    frames, gt = synthetic_sequence(10, H, W, K, np.random.default_rng(0))
    return [np.asarray(f, np.float32) for f in frames], gt


def jax_points(depth):
    return jax_backproject(jnp.asarray(depth), jnp.asarray(K))


def torch_points(depth):
    return backproject_device(torch.from_numpy(depth), torch.from_numpy(K))


def ate(trajectory, gt):
    errs = [np.linalg.norm(-R.T @ t - (-Rg.T @ tg)) for (R, t), (Rg, tg) in zip(trajectory, gt)]
    return float(np.sqrt(np.mean(np.square(errs))))


def assert_same_poses(traj, ref, r_tol=R_TOL, t_tol=T_TOL):
    assert len(traj) == len(ref)
    for (R, t), (Rr, tr) in zip(traj, ref):
        np.testing.assert_allclose(R, Rr, rtol=0, atol=r_tol)
        np.testing.assert_allclose(t, tr, rtol=0, atol=t_tol)


@pytest.fixture(scope="module")
def runs(room):
    """Both packages tracked over the whole room sequence, with the
    per-frame (matched, new) counts."""
    frames, _ = room
    ours = PlaneSlam(H, W, Config(**ROOM), max_landmarks=32, device="cpu")
    ref = JaxPlaneSlam(H, W, JaxConfig(**ROOM), max_landmarks=32)
    counts, ref_counts = [], []
    for depth in frames:
        a = ours.process_frame(torch_points(depth))
        b = ref.process_frame(jax_points(depth))
        counts.append((int(a.num_matched), int(a.num_new)))
        ref_counts.append((int(b.num_matched), int(b.num_new)))
    return ours, ref, counts, ref_counts


def test_extract_plane_obs_matches_jax(room):
    frames, _ = room
    cfg = Config(**ROOM)
    jextract = jax.jit(functools.partial(jfrontend.extract_plane_obs, image_height=H,
                                         image_width=W, config=JaxConfig(**ROOM)))
    for depth in frames[:4]:
        got = frontend.extract_plane_obs(torch_points(depth), H, W, cfg)
        ref = jextract(jax_points(depth))
        np.testing.assert_array_equal(got.weight.numpy(), np.asarray(ref.weight))
        keep = np.asarray(ref.weight) > 0
        # Same cells, same planes. A plane's sums count its seed cell twice
        # (the reference's accumulator seeding), and on these noise-free
        # walls the seed, the cell of least MSE, is decided by float32 noise:
        # another seed moves a wall's centroid by tens of mm (the reference
        # package's own jitted and eager runs differ by 32 mm here) and its
        # normal by up to 1.3e-4 (both normals lie about 3e-3 off the room's
        # exact ones); the centroid stays on the plane.
        np.testing.assert_allclose(got.normal.numpy()[keep], np.asarray(ref.normal)[keep],
                                   rtol=0, atol=3e-4)
        np.testing.assert_allclose(got.d.numpy()[keep], np.asarray(ref.d)[keep],
                                   rtol=2e-4, atol=1e-2)
        np.testing.assert_allclose(got.mean.numpy()[keep], np.asarray(ref.mean)[keep],
                                   rtol=0, atol=50.0)
        on_plane = (got.mean * got.normal).sum(-1) + got.d
        assert float(on_plane.abs()[torch.from_numpy(keep)].max()) < 1.0


def test_slam_step_matches_jax_fed_its_state(room):
    """Frame by frame, the port's step gets the reference's observations,
    map and pose prior: the same matches and spawns, the same poses and map
    to float32 tolerances."""
    frames, _ = room
    jcfg = JaxConfig(**ROOM)
    params = jfrontend.AssociationParams()
    step_kw = dict(odom_iterations=8, min_obs_weight=0.0)
    jstep = jax.jit(functools.partial(jfrontend.slam_step, assoc=params, **step_kw))
    jextract = jax.jit(functools.partial(jfrontend.extract_plane_obs, image_height=H,
                                         image_width=W, config=jcfg))
    jmap, R, t = jfrontend.init_map(32), jnp.eye(3), jnp.zeros(3)
    spawned = matched = 0
    for depth in frames:
        obs = jextract(jax_points(depth))
        ref, jnext = jstep(obs, jmap, R, t)
        got, nxt = frontend.slam_step(
            plane_obs_from_numpy(fields_of(obs)), map_state_from_numpy(fields_of(jmap)),
            torch.from_numpy(np.asarray(R)), torch.from_numpy(np.asarray(t)),
            assoc=frontend.AssociationParams(), **step_kw)
        np.testing.assert_array_equal(got.matches_lm.numpy(), np.asarray(ref.matches_lm))
        assert int(got.num_new) == int(ref.num_new)
        assert int(nxt.count) == int(jnext.count)
        np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=0, atol=0.05)
        np.testing.assert_array_equal(nxt.weight.numpy() > 0, np.asarray(jnext.weight) > 0)
        np.testing.assert_allclose(nxt.weight.numpy(), np.asarray(jnext.weight), rtol=1e-6)
        np.testing.assert_allclose(nxt.normal.numpy(), np.asarray(jnext.normal), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(nxt.d.numpy(), np.asarray(jnext.d), rtol=1e-5, atol=0.05)
        spawned += int(ref.num_new)
        matched += int(ref.num_matched)
        jmap, R, t = jnext, ref.R, ref.t
    assert spawned >= 3 and matched >= 9


def test_whole_run_matches_jax(room, runs):
    _, gt = room
    ours, ref, counts, ref_counts = runs
    assert counts == ref_counts
    assert int(ours.map.count) == int(ref.map.count) >= 3
    assert all(m > 0 for m, _ in counts[1:])
    assert ate(ours.trajectory, gt) < 300.0 and ate(ref.trajectory, gt) < 300.0
    assert_same_poses(ours.trajectory, ref.trajectory)


@pytest.fixture
def from_jax_checkpoint(runs, tmp_path, monkeypatch):
    """A fresh port PlaneSlam loaded from the reference's npz checkpoint,
    and a copy of the reference slam: both start from the same state."""
    _, ref, _, _ = runs
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)   # the npz form
    path = str(tmp_path / "jax_slam")
    ref.save(path)
    ours = PlaneSlam(H, W, Config(**ROOM), max_landmarks=32, device="cpu")
    ours.load(path)
    twin = JaxPlaneSlam(H, W, JaxConfig(**ROOM), max_landmarks=32)
    twin.load(path)
    return ours, twin


def test_checkpoint_from_jax_restores_the_state(runs, from_jax_checkpoint):
    ours, _ = from_jax_checkpoint
    _, ref, _, _ = runs
    assert_same_poses(ours.trajectory, ref.trajectory, 0, 0)
    for a, b in zip(ours.map, ref.map):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(ours._keyframes) == len(ref._keyframes)
    np.testing.assert_array_equal(ours.R.numpy(), np.asarray(ref.R))


def test_refine_matches_jax_dense(room, from_jax_checkpoint):
    """The same BA problem from the same state, and refine() lands where the
    reference's dense run_ba (its refine(mesh=False)) does."""
    from deplex_tpu.slam.ba import run_ba as jax_run_ba
    from deplex_tpu.slam.planes import from_cp as jax_from_cp

    _, gt = room
    ours, twin = from_jax_checkpoint
    before = ate(ours.trajectory, gt)
    prob, jprob = ours.build_ba_problem(), twin.build_ba_problem()
    for name in ("obs_lm", "obs_normal", "obs_d", "obs_w", "R", "t", "eta", "odo_R", "odo_t"):
        np.testing.assert_allclose(getattr(prob, name).numpy(), np.asarray(getattr(jprob, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    ref = jax.jit(jax_run_ba, static_argnames=("iterations",))(jprob, iterations=8)
    ours.refine(iterations=8)
    assert_same_poses(ours.trajectory, list(zip(np.asarray(ref.R), np.asarray(ref.t))),
                      2e-4, 1.0)
    np.testing.assert_allclose(ours.map.d.numpy(), np.asarray(jax_from_cp(ref.eta)[1]),
                               rtol=1e-4, atol=0.5)
    after = ate(ours.trajectory, gt)
    assert np.isfinite(after) and after < 1.5 * before


def test_optimize_trajectory_matches_jax(room, from_jax_checkpoint):
    _, gt = room
    ours, twin = from_jax_checkpoint
    before = ate(ours.trajectory, gt)
    g, jg = ours.build_pose_graph(), twin.build_pose_graph()
    np.testing.assert_array_equal(g.edge_a.numpy(), np.asarray(jg.edge_a))
    np.testing.assert_array_equal(g.edge_b.numpy(), np.asarray(jg.edge_b))
    np.testing.assert_allclose(g.meas_R.numpy(), np.asarray(jg.meas_R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(g.meas_t.numpy(), np.asarray(jg.meas_t), rtol=0, atol=0.5)
    ours.optimize_trajectory(iterations=10)
    twin.optimize_trajectory(iterations=10)
    assert_same_poses(ours.trajectory, twin.trajectory, 2e-4, 1.0)
    assert ate(ours.trajectory, gt) < 1.5 * before


def test_checkpoint_resume_is_exact(room, tmp_path):
    """Save after 5 frames, resume in a fresh PlaneSlam: the rest of the run
    equals the uninterrupted one bit for bit; the npz loads in the reference."""
    from deplex_tpu.slam import checkpoint as jck

    frames, _ = room
    cfg = Config(**ROOM)
    full = PlaneSlam(H, W, cfg, max_landmarks=32, device="cpu")
    first = PlaneSlam(H, W, cfg, max_landmarks=32, device="cpu")
    for i, depth in enumerate(frames):
        full.process_frame(torch_points(depth))
        if i < 5:
            first.process_frame(torch_points(depth))
    first.save(str(tmp_path / "ck"))
    resumed = PlaneSlam(H, W, cfg, max_landmarks=32, device="cpu")
    resumed.load(str(tmp_path / "ck"))
    for depth in frames[5:]:
        resumed.process_frame(torch_points(depth))
    assert_same_poses(resumed.trajectory, full.trajectory, 0, 0)
    for a, b in zip(resumed.map, full.map):
        assert torch.equal(a, b)
    state = jck.load_checkpoint(str(tmp_path / "ck"), first._snapshot_state())
    np.testing.assert_array_equal(np.asarray(state["traj_t"]),
                                  np.stack([t for _, t in first.trajectory]))


def test_refine_with_a_mesh_is_refused(runs):
    ours, _, _, _ = runs
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        ours.refine(mesh=object())


def test_render_sequence_equals_jax_package():
    rng = np.random.default_rng(5)
    depth = (1500 + 300 * rng.random((24, 32))).astype(np.uint16)
    depth[3:6, 4:9] = 0
    Kw = np.array([[30.0, 0, 15.5], [0, 30.0, 11.5], [0, 0, 1]], np.float32)
    poses = warp.smooth_trajectory(4, seed=3)
    for (R, t), (Rj, tj) in zip(poses, jwarp.smooth_trajectory(4, seed=3)):
        np.testing.assert_array_equal(R, Rj)
        np.testing.assert_array_equal(t, tj)
    got = warp.render_sequence(depth, Kw, poses)
    ref = jwarp.render_sequence(depth, Kw, poses)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(warp.warp_depth(depth, Kw, *poses[2]),
                                  jwarp.warp_depth(depth, Kw, *poses[2]))
