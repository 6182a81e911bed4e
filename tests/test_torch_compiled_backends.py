"""The SLAM backends as compiled entry points (``compiled``): ``run_ba``,
``optimize_pose_graph`` and ``PlaneSlam._pair_measure_fn``, on the CPU.

On the CPU ``compiled.call`` runs each backend's function as it is, so the
pair measurement is held to the JAX package's ``PlaneSlam._pair_measure_fn``
on the same numpy inputs (the edge axis padded as the JAX package pads it)
within ``tests/test_torch_slam.py``'s odometry tolerances, and to the
unpadded call; ``run_ba`` and ``optimize_pose_graph``, which pad their
keyframe, node and edge axes to power-of-two buckets (``compiled.bucket``),
are held to their unpadded loops as the port is held to the JAX package.
The graph keys, the replays and what a recording may not do are exercised
with ``tests/test_torch_compiled.py``'s stand-in graph, which makes the CPU
count as a card: a backend's first call runs eagerly and records nothing
(``eager_once``), every later new key is recorded and replayed, equal keys
share one graph, and another iteration count, bucket or prior set records
another. A recording run under a dispatch mode that refuses
``_local_scalar_dense`` (``.item()``, ``bool()`` or ``int()`` of a tensor)
and ``lift_fresh`` (a tensor made from host data) shows that no backend
waits on the host or copies from pageable memory inside its graph, which
would make the capture fail on a card. ``run_ba``, the pose graph,
``refine`` and ``optimize_trajectory`` are held to the JAX package in
``tests/test_torch_slam.py`` and ``tests/test_torch_slam_frontend.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode

from deplex_tpu import Config as JaxConfig
from deplex_tpu.slam import PlaneSlam as JaxPlaneSlam
from deplex_tpu.slam.planes import PlaneObs as JaxPlaneObs
from deplex_tpu_torch import Config, PlaneSlam, compiled
from deplex_tpu_torch.interop import ba_problem_from_numpy, pose_graph_from_numpy
from deplex_tpu_torch.slam import ba, pose_graph
from deplex_tpu_torch.slam.frontend import PAIR_ITERATIONS
from deplex_tpu_torch.slam.odometry import estimate_pose
from deplex_tpu_torch.slam.planes import PlaneObs

from .test_torch_compiled import StandInGraph, stand_in  # noqa: F401  (fixture)
from .test_torch_slam import _chain, held_to_jax, make_problem, perturbed, to_f64, with_priors
from .test_torch_slam_frontend import H, ROOM, W, room, torch_points  # noqa: F401  (fixture)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tracked(room, tmp_path_factory):  # noqa: F811
    """The port's PlaneSlam over the synthetic room's 10 frames, saved; a
    test loads its own copy (``fresh``)."""
    frames, _ = room
    slam = PlaneSlam(H, W, Config(**ROOM), max_landmarks=32, device="cpu")
    for depth in frames:
        slam.process_frame(torch_points(depth))
    path = str(tmp_path_factory.mktemp("backends") / "room")
    slam.save(path)
    return path


def fresh(path) -> PlaneSlam:
    slam = PlaneSlam(H, W, Config(**ROOM), max_landmarks=32, device="cpu")
    slam.load(path)
    return slam


def all_pairs(slam, seed=0):
    """Every keyframe pair (a < b): (1, 2) first (frame 0 matched nothing:
    it spawned the map), the others in a seeded order, so that distant
    pairs, which share few planes, come early."""
    K = len(slam._keyframes)
    rest = [(a, b) for a in range(K) for b in range(a + 1, K) if (a, b) != (1, 2)]
    return [(1, 2)] + [rest[i] for i in np.random.default_rng(seed).permutation(len(rest))]


def of_entry(entry):
    return [g for g in compiled.graphs() if g.key[0] == entry]


def ba_fields(K=6, M=8, priors=True, seed=13):
    rng = np.random.default_rng(seed)
    f = perturbed(make_problem(rng, K=K, M=M, noise=0.01), rng)
    return with_priors(f, rng) if priors else f


# --- the padded pair measurement ---------------------------------------------

@pytest.mark.parametrize("E", [1, 5, 8, 9])
def test_pair_measurement_padded_equals_jax_and_the_unpadded_call(E, tracked):
    """The first E rows of the padded call equal the JAX package's jitted
    vmap on the same numpy inputs (tests/test_torch_slam.py's odometry
    tolerances) and the port's unpadded call; padded edges stay at R0 = I,
    t0 = 0 with no inliers."""
    slam = fresh(tracked)
    compiled.clear()
    inputs = slam._pair_inputs(all_pairs(slam)[:E])
    Epad = max(8, 1 << (E - 1).bit_length())
    assert all(x.shape[0] == Epad for x in (*inputs[0], *inputs[1:]))
    got = slam._pair_measure_fn(*inputs)
    assert compiled.graphs() == [], "the CPU recorded a graph"

    unpadded = estimate_pose(PlaneObs(*(x[:E] for x in inputs[0])), *(x[:E] for x in inputs[1:]),
                             iterations=PAIR_ITERATIONS)
    for name in got._fields:
        torch.testing.assert_close(getattr(got, name)[:E], getattr(unpadded, name),
                                   rtol=0, atol=0, msg=name)

    jslam = JaxPlaneSlam(H, W, JaxConfig(**ROOM), max_landmarks=32)
    obs, rest = inputs[0], inputs[1:]
    ref = jslam._pair_measure_fn(JaxPlaneObs(*(jnp.asarray(x.numpy()) for x in obs)),
                                 *(jnp.asarray(x.numpy()) for x in rest))
    np.testing.assert_allclose(got.R[:E].numpy(), np.asarray(ref.R)[:E], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.t[:E].numpy(), np.asarray(ref.t)[:E], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.residual[:E].numpy(), np.asarray(ref.residual)[:E],
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_array_equal(got.num_inliers[:E].numpy(),
                                  np.asarray(ref.num_inliers)[:E])
    assert int(got.num_inliers[:E].sum()) > 0

    torch.testing.assert_close(got.R[E:], torch.eye(3).expand(Epad - E, 3, 3), rtol=0, atol=0)
    torch.testing.assert_close(got.t[E:], torch.zeros(Epad - E, 3), rtol=0, atol=0)
    assert int(got.num_inliers[E:].abs().sum()) == 0


# --- buckets: the padded problems equal the unpadded ones --------------------

def test_bucket_is_the_next_power_of_two_from_eight():
    assert [compiled.bucket(n) for n in (1, 5, 8, 9, 16, 17, 300, 435)] == \
        [8, 8, 8, 16, 16, 32, 512, 512]
    assert compiled.bucket(3, least=1) == 4


@pytest.mark.parametrize("K", [7, 8, 9])
def test_run_ba_padded_to_its_bucket_equals_the_unpadded_loop(K):
    """run_ba pads the keyframes to compiled.bucket(K) and cuts them back:
    the same LM loop on the unpadded problem computes the same math (the
    sums run in another order), held as the port is held to the JAX package
    (tests/test_torch_slam.py's held_to_jax), and the padded keyframes stay
    where they were."""
    p = ba_problem_from_numpy(ba_fields(K=K))
    got, got64 = (ba.run_ba(x, iterations=4, damping=1e-4) for x in (p, to_f64(p)))
    assert got.R.shape[0] == K and got.t.shape[0] == K
    ref, ref64 = (ba._lm_loop(x, 4, ba._damping(x, 1e-4), None) for x in (p, to_f64(p)))
    held_to_jax(got, got64, ref, ref64, ("R", "t", "eta", "cost"))
    Kp = compiled.bucket(K)
    padded = ba._lm_loop(ba.pad_problem_keyframes(p, Kp), 4, ba._damping(p, 1e-4), None)
    torch.testing.assert_close(padded.R[K:], torch.eye(3).expand(Kp - K, 3, 3), rtol=0, atol=0)
    torch.testing.assert_close(padded.t[K:], torch.zeros(Kp - K, 3), rtol=0, atol=0)


@pytest.mark.parametrize("K", [6, 8, 9])
def test_pose_graph_padded_to_its_buckets_equals_the_unpadded_loop(K):
    """optimize_pose_graph pads nodes and edges to their buckets and cuts the
    nodes back: the unpadded steps compute the same poses (held_to_jax), and
    the padded nodes stay at the identity."""
    g = pose_graph_from_numpy(_chain(9, K=K, cv=True)[0])

    def steps(h, n=3):
        for _ in range(n):
            h = pose_graph.pose_graph_step(h)
        return h

    got, got64 = (pose_graph.optimize_pose_graph(x, iterations=3) for x in (g, to_f64(g)))
    held_to_jax(got, got64, steps(g), steps(to_f64(g)), ("R", "t"))
    Kp, Ep = compiled.bucket(K), compiled.bucket(g.edge_a.shape[0])
    h = pose_graph.pad_pose_graph(g, Kp, Ep)
    assert h.edge_a.shape[0] == Ep and float(h.weight[g.edge_a.shape[0]:].abs().sum()) == 0.0
    h = steps(h)
    torch.testing.assert_close(h.R[K:], torch.eye(3).expand(Kp - K, 3, 3), rtol=0, atol=0)
    torch.testing.assert_close(h.t[K:], torch.zeros(Kp - K, 3), rtol=0, atol=0)


# --- graph keys, with the stand-in graph ---------------------------------------

def test_an_eager_once_entry_runs_eagerly_once_then_records_each_new_key(stand_in):
    """The first call runs fn and records nothing; every later new key is
    recorded without an eager run and replayed; clear() starts over."""
    runs = []

    def fn(x):
        runs.append(x.shape)
        return x + 1

    for n in (2, 2, 3, 3):
        out = compiled.call("b", fn, (torch.zeros(n),), eager_once=True)
        torch.testing.assert_close(out, torch.ones(n), rtol=0, atol=0)
    assert runs == [(2,), (2,), (3,)]          # eager, recorded, recorded
    assert sorted(g.replays for g in of_entry("b")) == [1, 2]
    compiled.clear()
    compiled.call("b", fn, (torch.zeros(4),), eager_once=True)
    assert of_entry("b") == [] and len(runs) == 4


def test_run_ba_records_one_graph_per_key_and_takes_the_damping_as_an_input(stand_in):
    p = ba_problem_from_numpy(ba_fields())
    ba.run_ba(p, iterations=2, damping=1e-4)
    assert of_entry("run_ba") == []                    # the first call: eager only
    ba.run_ba(p._replace(eta=p.eta + 1.0, t=p.t * 1.01), iterations=2, damping=1e-3)
    (g,) = of_entry("run_ba")
    assert g.replays == 1 and StandInGraph.made == 1
    # The damping is the last input: the recording took this call's.
    assert float(g.inputs[-1]) == pytest.approx(1e-3)
    torch.testing.assert_close(g.inputs[2], p.eta + 1.0, rtol=0, atol=0)
    # Another K of the bucket (6 and 5 pad to 8): the same graph.
    out = ba.run_ba(ba_problem_from_numpy(ba_fields(K=5)), iterations=2)
    assert out.R.shape[0] == 5 and g.replays == 2 and StandInGraph.made == 1
    # Another iteration count, bucket, or prior set: another graph each.
    ba.run_ba(p, iterations=3)
    ba.run_ba(ba_problem_from_numpy(ba_fields(K=9)), iterations=2)
    ba.run_ba(ba_problem_from_numpy(ba_fields(priors=False)), iterations=2)
    graphs = of_entry("run_ba")
    assert len(graphs) == 4 and StandInGraph.made == 4
    assert sorted(g.replays for g in graphs) == [1, 1, 1, 2]
    assert len({g.key[1] for g in graphs}) == 3      # iterations and priors
    assert sorted(g.inputs[0].shape[0] for g in graphs) == [8, 8, 8, 16]
    # The key names the priors present.
    assert graphs[-1].key[1] == (2, ("R", "t", "eta", "obs_normal", "obs_d", "obs_lm", "obs_w"))


def test_optimize_pose_graph_records_one_graph_per_key(stand_in):
    f, _, _ = _chain(9, cv=True)
    g = pose_graph_from_numpy(f)
    out = pose_graph.optimize_pose_graph(g, iterations=2)
    assert out.edge_a is g.edge_a and out.meas_R is g.meas_R and out.R.shape[0] == 6
    assert of_entry("optimize_pose_graph") == []       # the first call: eager only
    pose_graph.optimize_pose_graph(g._replace(t=g.t + 1.0), iterations=2)
    (rec,) = of_entry("optimize_pose_graph")
    assert rec.replays == 1
    # 7 nodes and 7 edges pad to the same buckets (8, 8) as 6 and 6.
    pose_graph.optimize_pose_graph(pose_graph_from_numpy(_chain(9, K=7, cv=True)[0]),
                                   iterations=2)
    assert rec.replays == 2
    pose_graph.optimize_pose_graph(g, iterations=3)
    pose_graph.optimize_pose_graph(g, iterations=2, damping=1e-4)
    pose_graph.optimize_pose_graph(g._replace(cv_w=None), iterations=2)
    pose_graph.optimize_pose_graph(pose_graph_from_numpy(_chain(9, K=9, cv=True)[0]),
                                   iterations=2)
    graphs = of_entry("optimize_pose_graph")
    assert len(graphs) == 5 and StandInGraph.made == 5
    assert sorted(g.replays for g in graphs) == [1, 1, 1, 1, 2]


def test_pair_measurement_shares_a_graph_within_an_edge_bucket(tracked, stand_in):
    slam = fresh(tracked)
    pairs = all_pairs(slam)
    for n in (9, 16, 12):                              # bucket 16
        slam._pair_measure_fn(*slam._pair_inputs(pairs[:n]))
    (g,) = of_entry("PlaneSlam.pair_measure_fn")
    assert g.replays == 2 and g.inputs[0].shape[0] == 16
    # The replay's static inputs hold the last call's padded edges.
    assert not bool(g.inputs[7][12:].any()) and bool(g.inputs[7][:12].any())    # has
    slam._pair_measure_fn(*slam._pair_inputs(pairs[:17]))   # bucket 32
    slam._pair_measure_fn(*slam._pair_inputs(pairs[:5]))    # bucket 8
    graphs = of_entry("PlaneSlam.pair_measure_fn")
    assert sorted(g.inputs[0].shape[0] for g in graphs) == [8, 16, 32]
    assert sorted(g.replays for g in graphs) == [1, 1, 2]


def test_plane_slam_backends_record_once_and_replay(tracked, stand_in):
    """refine() twice on one window: one "run_ba" graph, recorded by the
    second call and replayed; optimize_trajectory() twice: one graph and one
    replay for each of its two entries. Nothing else is recorded."""
    slam = fresh(tracked)
    for _ in range(2):
        slam.refine(iterations=2)
    (g,) = compiled.graphs()
    assert g.key[0] == "run_ba" and g.replays == 1
    for _ in range(2):
        slam.optimize_trajectory(iterations=2)
    entries = sorted((g.key[0], g.replays) for g in compiled.graphs())
    assert entries == [("PlaneSlam.pair_measure_fn", 1), ("optimize_pose_graph", 1),
                       ("run_ba", 1)]


# --- nothing inside a recording reads the host ----------------------------------

class HostReadGuard(TorchDispatchMode):
    """Refuses what makes a CUDA graph capture fail: a read of a device
    value on the host and a tensor made from host data."""

    REFUSED = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.lift_fresh.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.REFUSED:
            raise RuntimeError(f"host read inside a recording: {func}")
        return func(*args, **(kwargs or {}))


class GuardedGraph(StandInGraph):
    """A stand-in graph whose recording runs under HostReadGuard."""

    def capture_begin(self, pool=None):
        super().capture_begin(pool)
        self.guard = HostReadGuard()
        self.guard.__enter__()

    def capture_end(self):
        self.guard.__exit__(None, None, None)
        super().capture_end()


@pytest.fixture
def guarded(stand_in, monkeypatch):
    monkeypatch.setattr(compiled, "new_graph", GuardedGraph)


def test_the_guard_refuses_host_reads(guarded):
    for fn in (lambda x: x + torch.tensor(1.0), lambda x: x * x.sum().item()):
        with pytest.raises(RuntimeError, match="host read inside a recording"):
            compiled.call("f", fn, (torch.ones(2),))
    assert compiled.graphs() == []


def _run_ba():
    for _ in range(2):                    # the second call records
        ba.run_ba(ba_problem_from_numpy(ba_fields()), iterations=2)


def _pose_graph():
    for _ in range(2):
        pose_graph.optimize_pose_graph(pose_graph_from_numpy(_chain(9, cv=True)[0]),
                                       iterations=2)


def _pairs(path):
    slam = fresh(path)
    for _ in range(2):
        slam._pair_measure_fn(*slam._pair_inputs(all_pairs(slam)[:12]))


@pytest.mark.parametrize("entry", ["run_ba", "optimize_pose_graph", "PlaneSlam.pair_measure_fn"])
def test_no_backend_reads_the_host_while_it_is_recorded(entry, tracked, guarded):
    {"run_ba": _run_ba, "optimize_pose_graph": _pose_graph,
     "PlaneSlam.pair_measure_fn": lambda: _pairs(tracked)}[entry]()
    assert [g.key[0] for g in compiled.graphs()] == [entry]


RANSAC = dict(ransac_refinement=True, ransac_max_iterations=192, ransac_threshold=5.0)


def _ransac_entry(entry: str):
    """Two calls of a plane entry with stage 6 on a TUM crop (the second
    replays the graph the first recorded)."""
    from deplex_tpu_torch.parallel.batch import extract_depth_batch_jit, extract_planes_batch_jit
    from deplex_tpu_torch.pipeline import (depth_tensor, extract_planes_from_depth_jit,
                                           extract_planes_jit)
    from deplex_tpu_torch.utils.depth_image import backproject

    from .test_torch_compiled import tum_depth

    depth = np.ascontiguousarray(tum_depth()[0][200:260, 300:380])
    K = np.array([[60.0, 0, 40.0], [0, 60.0, 30.0], [0, 0, 1]], np.float32)
    cfg, size = Config(**RANSAC), dict(image_height=60, image_width=80)
    pts = torch.from_numpy(backproject(depth, K))
    call = {"extract_depth_batch_jit":
            lambda: extract_depth_batch_jit(depth_tensor(depth[None], "cpu"), K, config=cfg),
            "extract_planes_from_depth_jit":
            lambda: extract_planes_from_depth_jit(depth_tensor(depth, "cpu"), K, config=cfg),
            "extract_planes_jit": lambda: extract_planes_jit(pts, **size, config=cfg),
            "extract_planes_batch_jit":
            lambda: extract_planes_batch_jit(pts[None], **size, config=cfg)}[entry]
    return [call() for _ in range(2)]


@pytest.mark.parametrize("entry", ["extract_depth_batch_jit", "extract_planes_from_depth_jit",
                                   "extract_planes_jit", "extract_planes_batch_jit"])
def test_no_ransac_entry_reads_the_host_while_it_is_recorded(entry, stand_in, monkeypatch):
    """Stage 6 inside a plane entry: the loop runs its fixed number of
    chunks (calls are recorded here, as on a card) and nothing in it reads
    a device value on the host or copies from host memory (stage 6 runs
    under HostReadGuard; stages 1-5 run the CPU twins of K1-K3, which do)."""
    from deplex_tpu_torch import pipeline

    calls = []

    def guarded_refine(*args, **kwargs):
        assert kwargs["fixed_trip"]
        calls.append(1)
        with HostReadGuard():
            return refine(*args, **kwargs)
    refine = pipeline.refine_cells
    monkeypatch.setattr(pipeline, "refine_cells", guarded_refine)
    first, second = _ransac_entry(entry)
    assert [g.key[0] for g in compiled.graphs()] == [entry]
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    assert len(calls) == 2                  # the eager run and the recording
