"""deplex_tpu_torch's multi-process layers (parallel/, run_ba_sharded,
PlaneSlam.refine(mesh=...)) on two gloo CPU ranks, held to deplex_tpu.

``parallel.launcher`` starts two ranks of ``parallel.verify`` (which import
torch and the port, never jax) on the reference's own inputs, written to npz
here: tests/test_multiprocess.py's synthetic depth batch and BA problem, a
BA problem with motion priors whose 7 keyframes do not divide by the two
ranks, and a PlaneSlam state tracked over the synthetic room. This process
computes the JAX references. Extraction has no collective, so its labels
must be equal; the sharded BA sums in another order than the dense one, so
it agrees to Gauss-Newton accuracy, and the ranks agree bit for bit.
"""

import dataclasses
import json
import pathlib
import struct
import sys
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deplex_tpu.parallel.batch import extract_depth_batch as jax_extract_depth_batch
from deplex_tpu.parallel.verify import (synth_ba_problem, synth_depth, synth_intrinsics,
                                        verify_config)
from deplex_tpu.slam.ba import BAProblem as JaxBAProblem
from deplex_tpu.slam.ba import ba_step as jax_ba_step
from deplex_tpu.slam.ba import run_ba as jax_run_ba
from deplex_tpu_torch import Config, PlaneSlam
from deplex_tpu_torch.interop import ba_problem_from_numpy
from deplex_tpu_torch.parallel import distributed
from deplex_tpu_torch.parallel.batch import BatchPlaneExtractor, ShardedPlaneExtractor
from deplex_tpu_torch.parallel.launcher import launch
from deplex_tpu_torch.parallel.prefetch import iter_depth_batches, iter_depth_frames
from deplex_tpu_torch.parallel.verify import load_rank_outputs, write_slam_job
from deplex_tpu_torch.pipeline import backproject_device
from deplex_tpu_torch.slam.ba import run_ba, run_ba_sharded
from deplex_tpu_torch.utils.depth_image import backproject

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples" / "python"))

# The synthetic room of tests/test_torch_slam_frontend.py.
H, W = 120, 160
K_ROOM = np.array([[160.0, 0, W / 2 - 0.5], [0, 160.0, H / 2 - 0.5], [0, 0, 1]], np.float32)
ROOM = dict(patch_size=8, max_planes=16, max_region_growing_rounds=32,
            min_region_growing_cells_activated=3, min_region_growing_candidate_size=3,
            depth_discontinuity_threshold=600.0, min_cos_angle_merge=0.97)
# Each launch gets its own limit, so a hung rank fails the test.
LAUNCH_TIMEOUT_S = 180


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def save_problem(path, prob) -> None:
    np.savez(path, **{f: np.asarray(v) for f, v in prob._asdict().items() if v is not None})


def jax_problem(prob):
    return JaxBAProblem(*(None if f is None else jnp.asarray(np.asarray(f)) for f in prob))


def priors_problem():
    """The reference's synthetic problem at 7 keyframes, with odometry
    priors measured from its initial chain moved by 5 mm of noise, and
    constant-velocity priors. Unit weights keep the one damped step well
    conditioned in float32 (at weights 10 and 100 the port's and the
    reference's dense steps already differ by 0.65 mm)."""
    p = synth_ba_problem(7)
    R = np.asarray(p.R)
    t = np.asarray(p.t) + 5.0 * np.random.default_rng(5).normal(size=(7, 3)).astype(np.float32)
    odo_R = np.einsum("kij,klj->kil", R[:-1], R[1:])
    odo_t = t[:-1] - np.einsum("kij,kj->ki", odo_R, t[1:])
    return p._replace(odo_R=odo_R.astype(np.float32), odo_t=odo_t.astype(np.float32),
                      odo_w=np.ones(6, np.float32), cv_w=np.ones(5, np.float32))


def run_ranks(out, *args):
    results = launch([sys.executable, "-m", "deplex_tpu_torch.parallel.verify",
                      "--out", str(out), *map(str, args)],
                     num_processes=2, device="cpu", backend="gloo",
                     extra_env={"OMP_NUM_THREADS": "2"}, timeout=LAUNCH_TIMEOUT_S)
    assert [r.process_id for r in results] == [0, 1]
    return load_rank_outputs(out, 2)


@pytest.fixture(scope="module")
def room_slam():
    """The port's PlaneSlam tracked over the synthetic room on the CPU."""
    from run_slam import synthetic_sequence

    frames, _ = synthetic_sequence(10, H, W, K_ROOM, np.random.default_rng(0))
    slam = PlaneSlam(H, W, Config(**ROOM), max_landmarks=32, device="cpu")
    for depth in frames:
        slam.process_frame(backproject_device(torch.from_numpy(np.asarray(depth, np.float32)),
                                              torch.from_numpy(K_ROOM)))
    return slam


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, room_slam):
    """Two ranks on the reference's depth batch and BA problem, refining the
    room's state; returns both ranks' outputs and the inputs."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    depth, K = synth_depth(8), synth_intrinsics()
    np.savez(tmp / "depth.npz", depth=depth, K=K,
             config=json.dumps(dataclasses.asdict(verify_config())))
    prob = synth_ba_problem(8)
    save_problem(tmp / "ba.npz", prob)
    write_slam_job(str(tmp / "slam"), room_slam)
    outs = run_ranks(tmp / "out", "--depth", tmp / "depth.npz", "--ba-problem", tmp / "ba.npz",
                     "--slam-checkpoint", tmp / "slam", "--refine-iterations", 8)
    return outs, depth, K, prob


@pytest.fixture(scope="module")
def two_ranks_priors(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks_priors")
    prob = priors_problem()
    save_problem(tmp / "ba.npz", prob)
    return run_ranks(tmp / "out", "--ba-problem", tmp / "ba.npz"), prob


def test_ranks_form_one_cpu_group_without_jax(two_ranks):
    outs = two_ranks[0]
    for rank, o in enumerate(outs):
        assert int(o["world_size"]) == 2 and int(o["rank"]) == rank
        assert str(o["device"]) == "cpu"
        assert not bool(o["jax_imported"])
        # CPU tensors run the plain twins: no kernel launches.
        assert [int(o[f"launches_{k}"]) for k in ("cell_moments", "grow_rounds",
                                                   "merge_planes")] == [0, 0, 0]


def test_sharded_extraction_equals_jax(two_ranks):
    outs, depth, K, _ = two_ranks
    frame_idx = np.concatenate([o["frame_idx"] for o in outs])
    assert frame_idx.tolist() == list(range(8))          # disjoint, in rank order
    labels = np.concatenate([o["labels"] for o in outs])
    ref = np.asarray(jax.jit(lambda d, k: jax_extract_depth_batch(d, k, verify_config()))(
        jnp.asarray(depth), jnp.asarray(K)))
    np.testing.assert_array_equal(labels, ref)
    assert ref.max() > 0


def test_sharded_plane_extractor_equals_batch(two_ranks):
    outs, depth, K, _ = two_ranks
    clouds = np.stack([backproject(d, K) for d in depth])
    cfg = Config(**dataclasses.asdict(verify_config()))
    ref = BatchPlaneExtractor(depth.shape[1], depth.shape[2], cfg, device="cpu").process(clouds)
    for o in outs:
        assert o["points_labels"].shape == (8, depth.shape[1] * depth.shape[2])
        np.testing.assert_array_equal(o["points_labels"], ref)


def test_sharded_ba_step_matches_jax_dense(two_ranks):
    outs, _, _, prob = two_ranks
    dense = jax.jit(jax_ba_step)(jax_problem(prob))
    for o in outs:
        # Tolerances of tests/test_multiprocess.py: the sums run in another order.
        np.testing.assert_allclose(o["ba_R"], np.asarray(dense.R), atol=1e-4)
        np.testing.assert_allclose(o["ba_t"], np.asarray(dense.t), rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["ba_eta"], np.asarray(dense.eta), rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["ba_cost"], np.asarray(dense.cost), rtol=1e-3, atol=1e-4)


def test_run_ba_sharded_matches_jax_run_ba(two_ranks):
    outs, _, _, prob = two_ranks
    dense = jax.jit(jax_run_ba, static_argnames=("iterations",))(jax_problem(prob), iterations=4)
    for o in outs:
        np.testing.assert_allclose(o["lm_R"], np.asarray(dense.R), atol=1e-4)
        np.testing.assert_allclose(o["lm_t"], np.asarray(dense.t), rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["lm_eta"], np.asarray(dense.eta), rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["lm_cost"], np.asarray(dense.cost), rtol=1e-2, atol=1e-4)


def test_ranks_agree_bit_for_bit(two_ranks):
    a, b = two_ranks[0]
    for key in ("ba_R", "ba_t", "ba_eta", "ba_cost", "lm_R", "lm_t", "lm_eta", "lm_cost",
                "points_labels", "refine_R", "refine_t", "refine_normal", "refine_d"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_sharded_step_with_priors_and_padding_matches_jax(two_ranks_priors):
    """Odometry and constant-velocity priors (their chains cross the shard
    boundary) on 7 keyframes, padded to 8 over the two ranks."""
    outs, prob = two_ranks_priors
    jprob = jax_problem(prob)
    dense = jax.jit(jax_ba_step)(jprob)
    lm = jax.jit(jax_run_ba, static_argnames=("iterations",))(jprob, iterations=4)
    for o in outs:
        assert o["ba_R"].shape == (7, 3, 3) and o["lm_t"].shape == (7, 3)
        np.testing.assert_allclose(o["ba_R"], np.asarray(dense.R), atol=1e-3)
        np.testing.assert_allclose(o["ba_t"], np.asarray(dense.t), rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["lm_R"], np.asarray(lm.R), atol=1e-4)
        np.testing.assert_allclose(o["lm_t"], np.asarray(lm.t), rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["lm_eta"], np.asarray(lm.eta), rtol=5e-3, atol=0.2)
        np.testing.assert_allclose(o["lm_cost"], np.asarray(lm.cost), rtol=1e-2, atol=1e-4)
    np.testing.assert_array_equal(outs[0]["lm_eta"], outs[1]["lm_eta"])
    np.testing.assert_array_equal(outs[0]["ba_t"], outs[1]["ba_t"])


def test_refine_with_mesh_matches_dense_refine(two_ranks, room_slam, tmp_path):
    """Two ranks' refine(mesh=...) lands where one process's dense
    refine(mesh=False) does, to Gauss-Newton accuracy."""
    from deplex_tpu_torch.parallel.verify import load_slam_job

    outs = two_ranks[0]
    write_slam_job(str(tmp_path / "slam"), room_slam)
    dense = load_slam_job(str(tmp_path / "slam"), "cpu")
    dense.refine(iterations=8, mesh=False)
    R = np.stack([R for R, _ in dense.trajectory])
    t = np.stack([t for _, t in dense.trajectory])
    for o in outs:
        np.testing.assert_allclose(o["refine_R"], R, rtol=0, atol=2e-4)
        np.testing.assert_allclose(o["refine_t"], t, rtol=0, atol=1.0)
        np.testing.assert_allclose(o["refine_d"], dense.map.d.numpy(), rtol=1e-4, atol=0.5)
    tracked = np.stack([t for _, t in room_slam.trajectory])
    assert np.abs(t - tracked).max() > 1e-3           # the refinement moved the poses


@pytest.fixture
def world_of_one():
    """An initialized gloo group of one rank in this process."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_run_ba_sharded_over_a_world_of_one_equals_run_ba(world_of_one):
    prob = ba_problem_from_numpy(priors_problem()._asdict())
    dense = run_ba(prob, iterations=4)
    for mesh in (None, distributed.make_mesh("kf"), distributed.make_slam_mesh()):
        got = run_ba_sharded(prob, mesh, iterations=4)
        for a, b in zip(got, dense):
            assert torch.equal(a, b)


def test_collectives_and_meshes_over_a_world_of_one(world_of_one):
    g = distributed.make_mesh("data").get_group("data")
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(distributed.all_reduce_sum(x, g), x)
    assert torch.equal(distributed.all_gather_cat(x, g), x)
    assert torch.equal(x, torch.arange(6.0).reshape(3, 2))      # input untouched
    mesh = distributed.make_slam_mesh()
    assert mesh.mesh_dim_names == ("data", "kf") and tuple(mesh.mesh.shape) == (1, 1)
    assert distributed.local_batch_slice(8, mesh) == (0, 8)
    assert distributed.world_size() == 1
    pts = np.stack([backproject(d, synth_intrinsics()) for d in synth_depth(2)])
    cfg = Config(**dataclasses.asdict(verify_config()))
    sharded = ShardedPlaneExtractor(48, 64, cfg, device="cpu").process(pts)
    np.testing.assert_array_equal(sharded, BatchPlaneExtractor(48, 64, cfg, device="cpu")
                                  .process(pts))


def test_local_batch_slice_refuses_a_batch_the_mesh_does_not_divide():
    class TwoRanks:                       # the mesh interface local_batch_slice reads
        mesh_dim_names = ("data",)

        def size(self, dim):
            return 2

        def get_local_rank(self, axis):
            return 1

    assert distributed.local_batch_slice(8, TwoRanks()) == (4, 4)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(7, TwoRanks())


def test_refine_picks_sharded_only_in_a_world_of_many(room_slam, monkeypatch, tmp_path):
    """refine(): sharded when the initialized world has more than one rank
    (or a mesh is given), dense otherwise or with mesh=False."""
    from deplex_tpu_torch.parallel.verify import load_slam_job
    from deplex_tpu_torch.slam import ba

    write_slam_job(str(tmp_path / "slam"), room_slam)
    slam = load_slam_job(str(tmp_path / "slam"), "cpu")
    calls = []

    def sharded(problem, mesh=None, **kw):
        calls.append(mesh)
        return run_ba(problem, **kw)
    monkeypatch.setattr(ba, "run_ba_sharded", sharded)
    slam.refine(iterations=1)
    assert calls == []                                  # no group: dense
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    slam.refine(iterations=1, mesh=False)
    assert calls == []
    slam.refine(iterations=1)
    assert calls == [None]
    monkeypatch.setattr(distributed, "world_size", lambda: 1)
    mesh = object()
    slam.refine(iterations=1, mesh=mesh)
    assert calls == [None, mesh]


def test_run_ba_sharded_refuses_what_is_not_a_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_ba_sharded(ba_problem_from_numpy(synth_ba_problem(2)._asdict()), object())


def test_launcher_rejects_a_failing_rank(tmp_path):
    script = tmp_path / "boom.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['RANK'] == '1':\n"
                      "    sys.exit(3)\n"
                      "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="2/2 launched processes failed") as e:
        launch([str(script)], num_processes=2, timeout=120)
    assert "rc=3" in str(e.value)
    assert time.monotonic() - t0 < 30        # the waiting rank was killed


def test_launcher_kills_every_rank_at_the_timeout(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text("import time\ntime.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        launch([str(script)], num_processes=2, timeout=2)
    assert time.monotonic() - t0 < 30


def test_launcher_exports_the_env_contract(tmp_path):
    script = tmp_path / "env.py"
    script.write_text("import os\nprint(*(os.environ.get(k) for k in ('MASTER_ADDR', "
                      "'MASTER_PORT', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'DEPLEX_DEVICE', "
                      "'DEPLEX_BACKEND')))\n")
    results = launch([str(script)], num_processes=2, device="cuda", backend="gloo",
                     port=29512, timeout=60)
    assert [r.stdout.split() for r in results] == [
        ["127.0.0.1", "29512", "2", str(rank), str(rank), "cuda", "gloo"] for rank in range(2)]


def test_initialize_is_a_noop_without_the_env_contract_and_forwards_it(monkeypatch):
    """As tests/test_multiprocess.py: no contract, no group; with it,
    rank, size and the rendezvous endpoint are forwarded, and neither the
    device nor the backend is switched on the caller's behalf."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "DEPLEX_DEVICE", "DEPLEX_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    called = {}
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: called.setdefault("args", kw))
    assert distributed.initialize() is None and "args" not in called
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("DEPLEX_DEVICE", "cpu")
    assert distributed.initialize() == torch.device("cpu")
    args = dict(called["args"])
    args.pop("timeout")
    assert args == {"backend": "gloo", "init_method": "tcp://127.0.0.1:1",
                    "world_size": 2, "rank": 1}
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize("nccl")
    with pytest.raises(ValueError, match="not one of"):
        distributed.initialize("mpi")
    if not torch.cuda.is_available():
        monkeypatch.delenv("DEPLEX_DEVICE")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize()


def _png16(img: np.ndarray) -> bytes:
    """A 16-bit grayscale PNG, rows unfiltered."""
    h, w = img.shape
    raw = b"".join(b"\0" + img[r].astype(">u2").tobytes() for r in range(h))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_prefetch_yields_frames_in_order_and_pads_the_last_batch(tmp_path):
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 65536, size=(5, 6)).astype(np.uint16) for _ in range(7)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(tmp_path / f"{i}.png")
        paths[-1].write_bytes(_png16(f))
    got = list(iter_depth_frames(paths, workers=3, prefetch=2))
    assert len(got) == 7 and all(np.array_equal(a, b) for a, b in zip(got, frames))
    batches = list(iter_depth_batches(paths, 3, workers=2))
    assert [b.shape for b in batches] == [(3, 5, 6)] * 3
    np.testing.assert_array_equal(np.concatenate(batches)[:7], np.stack(frames))
    np.testing.assert_array_equal(batches[-1][1], frames[-1])
    np.testing.assert_array_equal(batches[-1][2], frames[-1])
    with pytest.raises(RuntimeError, match="Couldn't read image"):
        list(iter_depth_frames([tmp_path / "missing.png"]))
