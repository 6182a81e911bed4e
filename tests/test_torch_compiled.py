"""deplex_tpu_torch's compiled entry points (``compiled``; the ``*_jit``
functions and PlaneSlam's ``_frame_fn``) on the CPU, against the JAX
package's jitted programs, and the graph cache with a stand-in graph.

On the CPU ``compiled.call`` runs a counterpart's function as it is (the
plain twins, the same composition a card records), so the first tests hold
the six counterparts to ``deplex_tpu``'s compiled programs on the same
numpy inputs: labels and cylinder labels equal,
cylinder parameters within ``tests/test_torch_cylinder.py``'s bounds,
PlaneSlam's matches and spawns equal and its poses within
``tests/test_torch_slam_frontend.py``'s bounds. The rolled TUM frame of a
batch is held as ``tests/test_torch_pipeline.py`` holds it: its cell
normals round otherwise in XLA, so its planes are the same partition
under the same count. The cache tests swap ``torch.cuda.CUDAGraph`` for a
stand-in that records nothing (its "pool" takes the bytes the test sets)
and make the CPU count as a card, so the key, the reuse, the launch
accounting, the eviction by count and by bytes, a failed recording's
clean-up and the fresh outputs are exercised without one; ``chip_smoke.py`` [graphs] checks the real
graphs on the card.
"""

import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._pytree import tree_flatten

from deplex_tpu import Config as JaxConfig
from deplex_tpu.parallel.batch import extract_depth_batch_jit as jax_extract_depth_batch_jit
from deplex_tpu.parallel.batch import extract_planes_batch_jit as jax_extract_planes_batch_jit
from deplex_tpu.pipeline import extract_planes_from_depth_jit as jax_extract_from_depth_jit
from deplex_tpu.pipeline import extract_planes_jit as jax_extract_planes_jit
from deplex_tpu.pipeline import extract_primitives_jit as jax_extract_primitives_jit
from deplex_tpu.slam import PlaneSlam as JaxPlaneSlam
from deplex_tpu_torch import Config, PlaneExtractor, PlaneSlam, compiled, kernels
from deplex_tpu_torch.interop import fields_of
from deplex_tpu_torch.parallel.batch import (extract_depth_batch, extract_depth_batch_jit,
                                             extract_planes_batch_jit)
from deplex_tpu_torch.pipeline import (depth_tensor, extract_planes_from_depth_jit,
                                       extract_planes_jit, extract_primitives_jit)
from deplex_tpu_torch.utils.depth_image import backproject
from deplex_tpu_torch.utils.scenes import cylinder_scene
from deplex_tpu_torch.utils.warp import render_sequence, smooth_trajectory

from .conftest import DATA
from .test_torch_cylinder import CYL, assert_cylinders_close
from .test_torch_slam_frontend import R_TOL, T_TOL

H, W = 480, 640


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _same_planes(got, ref):
    """Same partition of the pixels into planes, under the same count."""
    pairs = np.unique(np.stack([got, ref]), axis=1)
    assert np.unique(pairs[0]).size == pairs.shape[1] == np.unique(pairs[1]).size
    assert int(got.max()) == int(ref.max())


@functools.lru_cache(maxsize=None)
def tum_depth():
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    depth = DepthImage(str(DATA / "tum" / "1341848230.910894.png")).data
    return depth, np.asarray(read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K")),
                             np.float32)


def tum_batch():
    """The TUM frame and the frame rolled by (3, 5), as tests/test_torch_pipeline.py."""
    depth, K = tum_depth()
    return np.stack([depth, np.roll(depth, (3, 5), (0, 1))]), K


def case_planes_from_depth():
    depth, K = tum_depth()
    got = extract_planes_from_depth_jit(depth_tensor(depth, "cpu"), K, config=Config())
    ref = jax_extract_from_depth_jit(jnp.asarray(depth), jnp.asarray(K), config=JaxConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.max()) == 34


def case_planes():
    depth, K = tum_depth()
    pts = backproject(depth, K)
    got = extract_planes_jit(torch.from_numpy(pts), image_height=H, image_width=W,
                             config=Config())
    ref = jax_extract_planes_jit(jnp.asarray(pts), image_height=H, image_width=W,
                                 config=JaxConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def case_depth_batch():
    batch, K = tum_batch()
    got = extract_depth_batch_jit(depth_tensor(batch, "cpu"), K, config=Config()).numpy()
    ref = np.asarray(jax_extract_depth_batch_jit(jnp.asarray(batch), jnp.asarray(K),
                                                 config=JaxConfig()))
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got[0], ref[0])
    _same_planes(got[1], ref[1])


def case_planes_batch():
    batch, K = tum_batch()
    pts = np.stack([backproject(d, K) for d in batch])
    got = extract_planes_batch_jit(torch.from_numpy(pts), image_height=H, image_width=W,
                                   config=Config()).numpy()
    ref = np.asarray(jax_extract_planes_batch_jit(jnp.asarray(pts), image_height=H,
                                                  image_width=W, config=JaxConfig()))
    np.testing.assert_array_equal(got[0], ref[0])
    _same_planes(got[1], ref[1])


def case_primitives():
    pts, h, w = cylinder_scene()
    got = extract_primitives_jit(torch.from_numpy(pts), image_height=h, image_width=w,
                                 config=Config(**CYL))
    ref = jax_extract_primitives_jit(pts, image_height=h, image_width=w,
                                     config=JaxConfig(**CYL))
    for key in ("plane_labels", "cylinder_labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    n = int(got["cylinders"].nr_cylinders)
    assert n >= 1 and n == int(ref["cylinders"].nr_cylinders)
    assert_cylinders_close(type(got["cylinders"])(*(f.numpy() for f in got["cylinders"])),
                           fields_of(ref["cylinders"]), n)


def case_slam_frame():
    """Three frames of the warped TUM sequence (chip_smoke.py [slam]'s
    sequence and arguments) through PlaneSlam.process_frame: the same
    matches, spawns and landmark count frame by frame.

    Poses: the two packages' frame 0 is the identity. From frame 1 on, the
    end-to-end poses differ by stage 1's float32 noise (ROADMAP queue 3):
    on this noise-free render a wall's seed, its cell of least MSE, is a
    near tie that the two round apart, the seed cell counts twice in a
    plane's sums, and frame 0's landmarks move by up to 10 mm (1.2e-4 in
    rotation and 0.8 mm at frame 1). So the poses are held where the noise
    cannot reach them: the port's stages 2-4 fed the JAX package's cell
    statistics give its planes (normals 1e-5, offsets 0.05 mm), and the
    port's tracking step fed its observations, map and prior gives its
    pose within tests/test_torch_slam_frontend.py's fed-state tolerance
    (1e-5 rotation, 0.05 mm)."""
    import jax

    from deplex_tpu.pipeline import extract_planes_debug as jax_debug
    from deplex_tpu.slam import frontend as jfrontend
    from deplex_tpu_torch.interop import (cell_stats_from_numpy, map_state_from_numpy,
                                          plane_obs_from_numpy)
    from deplex_tpu_torch.ops.growing import grid_of_stats
    from deplex_tpu_torch.pipeline import grow_planes, merge_planes
    from deplex_tpu_torch.slam import frontend

    depth, K = tum_depth()
    frames = [backproject(np.clip(np.round(d), 0, 65535).astype(np.uint16), K)
              for d in render_sequence(depth, K, smooth_trajectory(3, seed=0))]
    ini = str(DATA / "configs" / "TUM_fr3_long_val.ini")
    cfg, jcfg = Config.from_ini(ini), JaxConfig.from_ini(ini)
    slam = PlaneSlam(H, W, cfg, max_landmarks=128, odom_iterations=10, device="cpu")
    ref = JaxPlaneSlam(H, W, jcfg, max_landmarks=128, odom_iterations=10)
    debug = jax.jit(functools.partial(jax_debug, image_height=H, image_width=W, config=jcfg))
    jextract = jax.jit(functools.partial(jfrontend.extract_plane_obs, image_height=H,
                                         image_width=W, config=jcfg))
    for i, pts in enumerate(frames):
        jmap, jR, jt = ref.map, ref.R, ref.t
        got, want = slam.process_frame(pts), ref.process_frame(pts)
        np.testing.assert_array_equal(got.matches_lm.numpy(), np.asarray(want.matches_lm))
        assert int(got.num_matched) == int(want.num_matched)
        assert int(got.num_new) == int(want.num_new)
        assert int(slam.map.count) == int(ref.map.count)
        if i == 0:
            np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=R_TOL)
            np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=T_TOL)
        # Stages 2-4 fed the JAX package's cell statistics.
        jd = debug(jnp.asarray(pts))
        stats = cell_stats_from_numpy({k: np.asarray(v) for k, v in jd["stats"]._asdict().items()},
                                      add_batch_axis=True)
        labels_map, segments = grow_planes(grid_of_stats(stats, cfg), cfg)
        _, merged = merge_planes(labels_map, segments, cfg)
        n = int(merged.nr_planes[0])
        np.testing.assert_allclose(merged.normal[0, :n].numpy(),
                                   np.asarray(jd["merged"].normal)[:n], rtol=0, atol=1e-5)
        np.testing.assert_allclose(merged.d[0, :n].numpy(), np.asarray(jd["merged"].d)[:n],
                                   rtol=1e-5, atol=0.05)
        # The tracking step fed the JAX package's observations, map and prior.
        step, _ = frontend.slam_step(
            plane_obs_from_numpy(fields_of(jextract(jnp.asarray(pts)))),
            map_state_from_numpy(fields_of(jmap)), torch.from_numpy(np.array(jR)),
            torch.from_numpy(np.array(jt)), assoc=frontend.AssociationParams(),
            odom_iterations=10, min_obs_weight=0.0)
        np.testing.assert_array_equal(step.matches_lm.numpy(), np.asarray(want.matches_lm))
        np.testing.assert_allclose(step.R.numpy(), np.asarray(want.R), rtol=0, atol=1e-5)
        np.testing.assert_allclose(step.t.numpy(), np.asarray(want.t), rtol=0, atol=0.05)


COUNTERPARTS = {"extract_planes_from_depth_jit": case_planes_from_depth,
                "extract_planes_jit": case_planes,
                "extract_depth_batch_jit": case_depth_batch,
                "extract_planes_batch_jit": case_planes_batch,
                "extract_primitives_jit": case_primitives,
                "PlaneSlam.frame_fn": case_slam_frame}


@pytest.mark.parametrize("name", list(COUNTERPARTS))
def test_counterpart_equals_jax_compiled_program(name):
    compiled.clear()
    COUNTERPARTS[name]()
    assert compiled.graphs() == [], "the CPU recorded a graph"


# --- the cache and its accounting, with a stand-in graph --------------------

CARD_BYTES = 1000          # the stand-in card's memory; the budget is its MAX_POOL_SHARE


class StandInGraph:
    """Stands in for torch.cuda.CUDAGraph: records nothing; a replay only
    counts itself (the static outputs keep what the recording run wrote).
    A recording takes `pool_size` bytes of the stand-in card's reserved
    memory; one that `invalidate()` was called in raises at its end, as
    CUDA's capture does after an operation it refused."""

    made = 0
    pool_size = 0
    current = None

    def __init__(self):
        StandInGraph.made += 1
        self.replays = 0
        self.recording = False
        self.invalid = False
        self.pool = None

    def capture_begin(self, pool=None):
        self.recording, self.pool = True, pool
        StandInGraph.current = self

    def capture_end(self):
        self.recording = False
        if self.invalid:
            raise RuntimeError("CUDA error: operation failed due to a previous error during "
                               "capture")
        RESERVED[0] += StandInGraph.pool_size

    def invalidate(self):
        self.invalid = True

    def replay(self):
        self.replays += 1


RESERVED = [0]
ENDED = []                 # pools whose routing compiled._end_routing ended


@pytest.fixture
def stand_in(monkeypatch):
    """The CPU counts as a card of CARD_BYTES, and graphs are StandInGraphs."""
    StandInGraph.made, StandInGraph.pool_size = 0, 0
    RESERVED[0] = 0
    ENDED.clear()
    pools = iter(range(1, 1000))
    compiled.clear()
    monkeypatch.setattr(compiled, "captures", lambda device: True)
    monkeypatch.setattr(compiled, "new_graph", StandInGraph)
    monkeypatch.setattr(compiled, "_new_pool", lambda: (0, next(pools)))
    monkeypatch.setattr(compiled, "_synchronize", lambda dev: None)
    monkeypatch.setattr(compiled, "_reserved", lambda dev: RESERVED[0])
    monkeypatch.setattr(compiled, "_card_bytes", lambda dev: CARD_BYTES)
    monkeypatch.setattr(compiled, "_side_stream", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(compiled, "_end_routing", lambda dev, pool: ENDED.append(pool))
    kernels.reset_launch_counts()
    yield
    compiled.clear()
    kernels.reset_launch_counts()


def launching(x):
    """A function that launches K1 once and K3 twice (by the wrappers'
    counts) and returns a tuple with a None, as plane_stages does."""
    kernels.cellstats.launches += 1
    kernels.merge.launches += 2
    return x * 2 + 1, None, {"sum": x.sum(0)}


def test_equal_calls_reuse_one_graph_and_return_fresh_tensors(stand_in):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    first = compiled.call("f", launching, (x,))
    assert StandInGraph.made == 1 and len(compiled.graphs()) == 1
    g = compiled.graphs()[0]
    assert g.graph.replays == 0 and not g.graph.recording
    second = compiled.call("f", launching, (x + 0,))
    third = compiled.call("f", launching, (x,))
    assert StandInGraph.made == 1 and g.graph.replays == 2 and g.replays == 2
    for out in (second, third):
        assert out[1] is None
        torch.testing.assert_close(out[0], first[0], rtol=0, atol=0)
        assert out[0].data_ptr() != g.outputs[0].data_ptr()
        assert out[2]["sum"].data_ptr() != g.outputs[2]["sum"].data_ptr()
    assert second[0].data_ptr() != third[0].data_ptr()
    # The static inputs are the graph's own buffers, refilled from each call.
    assert g.inputs[0].data_ptr() != x.data_ptr()
    torch.testing.assert_close(g.inputs[0], x, rtol=0, atol=0)


def test_recording_adds_no_launches_and_each_replay_adds_the_recorded_count(stand_in):
    x = torch.ones(4)
    compiled.call("f", launching, (x,))
    # The eager first call launched once; the recording's counts rolled back.
    idle = {"cell_finalize": 0, "grow_rounds": 0, "round_finalize": 0, "pixel_labels": 0,
            "ransac_sampling": 0, "ransac_scores": 0}
    assert kernels.launch_counts() == {"cell_moments": 1, "merge_planes": 2, **idle}
    assert compiled.graphs()[0].launches == {"cell_moments": 1, "merge_planes": 2, **idle}
    for _ in range(3):
        compiled.call("f", launching, (x,))
    assert kernels.launch_counts() == {"cell_moments": 4, "merge_planes": 8, **idle}


def test_a_failed_recording_raises_caches_nothing_and_counts_nothing(stand_in):
    """An op the capture refuses raises inside fn and invalidates the
    capture, so its end raises too: the pool's routing is ended, nothing
    is cached and the recording's launches are not counted. The next call
    records again."""
    calls = []

    def fails_when_recorded(x):
        calls.append(1)
        kernels.growing.launches += 1
        if len(calls) == 2:
            StandInGraph.current.invalidate()
            raise RuntimeError("operation not permitted when stream is capturing")
        return x + 1

    with pytest.raises(RuntimeError, match="previous error during capture"):
        compiled.call("g", fails_when_recorded, (torch.zeros(2),))
    assert compiled.graphs() == []
    assert kernels.launch_counts()["grow_rounds"] == 1    # the eager run's launch only
    assert ENDED == [StandInGraph.current.pool]
    torch.testing.assert_close(compiled.call("g", fails_when_recorded, (torch.zeros(2),)),
                               torch.ones(2))
    assert len(compiled.graphs()) == 1 and ENDED == [(0, 1)]


def test_a_recording_that_ends_cleanly_leaves_the_routing_to_torch(stand_in):
    """fn raising an error of its own does not invalidate the capture:
    torch's capture_end ends the routing, and fn's error comes through."""
    def broken(x):
        raise ValueError("a bug in fn")

    with pytest.raises(ValueError, match="a bug"):
        compiled.capture("h", broken, (torch.zeros(2),))
    assert ENDED == [] and compiled.graphs() == []


def test_the_key_separates_config_shape_dtype_device_and_intrinsics(stand_in):
    x = torch.zeros(3)
    base = compiled.cache_key("e", (Config(), (1.0, 2.0, 3.0, 4.0)), [compiled.spec(x)])
    assert base == compiled.cache_key("e", (Config(), (1.0, 2.0, 3.0, 4.0)),
                                      [compiled.spec(torch.ones(3))])
    others = [
        compiled.cache_key("e2", (Config(), (1.0, 2.0, 3.0, 4.0)), [compiled.spec(x)]),
        compiled.cache_key("e", (Config(patch_size=8), (1.0, 2.0, 3.0, 4.0)),
                           [compiled.spec(x)]),
        compiled.cache_key("e", (Config(), (1.0, 2.0, 3.0, 4.5)), [compiled.spec(x)]),
        compiled.cache_key("e", (Config(), (1.0, 2.0, 3.0, 4.0)), [compiled.spec(torch.zeros(4))]),
        compiled.cache_key("e", (Config(), (1.0, 2.0, 3.0, 4.0)),
                           [compiled.spec(torch.zeros(3, dtype=torch.float64))]),
        compiled.cache_key("e", (Config(), (1.0, 2.0, 3.0, 4.0)),
                           [compiled.spec(torch.zeros(3, device="meta"))]),
    ]
    assert len({base, *others}) == len(others) + 1
    assert compiled.spec_of((3,), torch.float32, "cpu") == compiled.spec(x)


@pytest.fixture
def rerunning(stand_in, monkeypatch):
    """A stand-in graph whose replay runs the recorded function again on
    its static inputs, into its static outputs: a replay then gives the
    labels of the inputs it was loaded with, as a card's does."""
    record = compiled.capture

    def capture(entry, fn, inputs, static=()):
        graph = record(entry, fn, inputs, static)

        def rerun():
            fresh = tree_flatten(fn(*graph.inputs))[0]
            for dst, src in zip(tree_flatten(graph.outputs)[0], fresh):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
        graph.graph.rerun = rerun
        return graph
    monkeypatch.setattr(compiled, "capture", capture)
    monkeypatch.setattr(StandInGraph, "replay", lambda self: self.rerun())


def test_the_depth_entries_record_one_graph_for_two_cameras_and_one_per_config_and_shape(
        rerunning):
    """Through extract_depth_batch_jit on small frames: equal calls share a
    graph, and so do two cameras (the intrinsics are an input); another
    config or batch size records another; every call's labels are the eager
    function's for its own camera."""
    depth = depth_tensor(np.ascontiguousarray(tum_depth()[0][200:260, 300:380]), "cpu")
    K1 = np.array([[60.0, 0, 40.0], [0, 60.0, 30.0], [0, 0, 1]], np.float32)
    K2 = K1.copy()
    K2[0, 0] *= 1.3
    K2[0, 2] += 9.0
    batch1, batch2 = depth[None], torch.stack([depth, depth])
    calls = [(batch1, K1, Config()), (batch1, K1, Config()), (batch1, K2, Config()),
             (batch1, K1, Config(patch_size=8)), (batch2, K1, Config()), (batch1, K2, Config())]
    labels = []
    for d, K, cfg in calls:
        got = extract_depth_batch_jit(d, K, config=cfg)
        ref = extract_depth_batch(d, K, cfg).to(torch.uint8)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        labels.append(got)
    assert not torch.equal(labels[0], labels[2])          # the cameras see other planes
    assert StandInGraph.made == 3
    assert sorted(g.replays for g in compiled.graphs()) == [0, 0, 3]


def jax_rank_draws(counts, iterations, generator=None, *, raw=None):
    """The port's draw_ranks with the JAX package's draws: every frame's
    ranks as its vmapped refine_labels draws them (one key per plane, split
    from the default key, randint over [0, max(count, 1)))."""
    import jax

    keys = jax.random.split(jax.random.PRNGKey(0), counts.shape[-1])
    c = counts.reshape(-1, counts.shape[-1]).cpu().numpy()
    ranks = np.stack([np.stack([np.asarray(jax.random.randint(
        keys[p], (iterations, 3), 0, max(int(row[p]), 1))) for p in range(len(row))])
        for row in c])
    return torch.from_numpy(ranks).reshape(*counts.shape, iterations, 3).to(counts.device)


@pytest.mark.parametrize("ratio", [0.15, 0.5, 1.0])
def test_the_compiled_ransac_slice_equals_jax(stand_in, monkeypatch, ratio):
    """extract_depth_batch_jit with stage 6 on two TUM crops (K = 192
    hypotheses, two chunks, the last padded), recorded with the stand-in
    and replayed, against the JAX package's extract_depth_batch_jit (XLA on
    the CPU) with its own draws: the labels are equal, and stage 6 removed
    pixels."""
    from deplex_tpu_torch.ops import ransac

    monkeypatch.setattr(ransac, "draw_ranks", jax_rank_draws)
    depth = tum_depth()[0]
    batch = np.stack([depth[200:260, 300:380], depth[260:320, 120:200]])
    K = np.array([[60.0, 0, 40.0], [0, 60.0, 30.0], [0, 0, 1]], np.float32)
    kw = dict(ransac_refinement=True, ransac_max_iterations=192, ransac_inliers_ratio=ratio,
              ransac_threshold=5.0)
    ref = np.asarray(jax_extract_depth_batch_jit(jnp.asarray(batch), jnp.asarray(K),
                                                 config=JaxConfig(**kw)))
    d = depth_tensor(batch, "cpu")
    first = extract_depth_batch_jit(d, K, config=Config(**kw))        # eager, then recorded
    replayed = extract_depth_batch_jit(d, K, config=Config(**kw))
    assert StandInGraph.made == 1 and compiled.graphs()[0].replays == 1
    for got in (first, replayed):
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)
    coarse = extract_depth_batch(d, K, Config()).numpy()
    assert all(0 < (ref[b] > 0).sum() < (coarse[b] > 0).sum() for b in range(2))


def test_eviction_past_the_bound_drops_the_least_recently_used(stand_in, monkeypatch):
    monkeypatch.setattr(compiled, "MAX_GRAPHS", 3)
    xs = [torch.zeros(n) for n in range(1, 5)]
    for x in xs[:3]:
        compiled.call("f", launching, (x,))
    compiled.call("f", launching, (xs[0],))              # xs[0] is now the most recent
    compiled.call("f", launching, (xs[3],))              # past the bound: xs[1] goes
    assert len(compiled.graphs()) == 3
    assert [g.key[2][0][0] for g in compiled.graphs()] == [(3,), (1,), (4,)]
    made = StandInGraph.made
    compiled.call("f", launching, (xs[1],))              # recorded again
    assert StandInGraph.made == made + 1 and len(compiled.graphs()) == 3


def test_eviction_keeps_the_pools_within_the_cards_share(stand_in):
    """Each graph's pool takes 100 of the card's 1000 bytes: with a share
    of 0.25 two graphs fit, a third drops the least recently used; a graph
    larger than the whole share stays alone."""
    assert compiled.MAX_POOL_SHARE * CARD_BYTES == 250
    StandInGraph.pool_size = 100
    xs = [torch.zeros(n) for n in range(1, 5)]
    for x in xs[:2]:
        compiled.call("f", launching, (x,))
    assert compiled.pool_bytes() == compiled.pool_bytes("cpu") == 200
    compiled.call("f", launching, (xs[0],))              # xs[0] is now the most recent
    compiled.call("f", launching, (xs[2],))              # 300 > 250: xs[1] goes
    assert [g.key[2][0][0] for g in compiled.graphs()] == [(1,), (3,)]
    assert [g.pool_bytes for g in compiled.graphs()] == [100, 100]
    assert compiled.pool_bytes() == 200
    StandInGraph.pool_size = 400
    compiled.call("f", launching, (xs[3],))
    assert [g.key[2][0][0] for g in compiled.graphs()] == [(4,)]
    assert compiled.pool_bytes() == 400
    assert compiled.pool_bytes("meta") == 0


def test_the_cpu_records_nothing():
    compiled.clear()
    out = compiled.call("f", lambda x: x + 1, (torch.zeros(2),))
    torch.testing.assert_close(out, torch.ones(2))
    assert compiled.graphs() == []


# --- the host layers' spans --------------------------------------------------

SPANS = ("io.upload", "io.download", "entry", "entry.key", "entry.load", "entry.replay",
         "entry.fresh", "entry.eager", "entry.capture")
SMALL_K = np.array([[60.0, 0, 40.0], [0, 60.0, 30.0], [0, 0, 1]], np.float32)


def small_depth() -> np.ndarray:
    return np.ascontiguousarray(tum_depth()[0][200:260, 300:380])


def traced_spans(*calls) -> list:
    """Each call of `calls` under a profiler, inside a span "call" as the
    benchmark's harness opens one: per call, its host spans as (name,
    parent span) in the order they started."""
    with torch.profiler.profile() as prof:
        for fn in calls:
            with torch.profiler.record_function("call"):
                fn()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    spans = {id(e): [] for e in events if e.name == "call"}
    for e in events:
        if e.name in SPANS:
            top = e.cpu_parent
            while top.name != "call":
                top = top.cpu_parent
            spans[id(top)].append((e.name, e.cpu_parent.name))
    return list(spans.values())


@pytest.mark.parametrize("path", ["cpu", "stand_in"])
def test_process_depth_spans_nest_on_the_callers_thread(request, path):
    """A camera's call: the depth's and the numpy K's uploads, the entry, the
    labels' download, each directly inside the caller's span; on a card
    (the stand-in) a replay's key, load, replay and fresh copies inside the
    entry."""
    if path == "stand_in":
        request.getfixturevalue("stand_in")
    ex = PlaneExtractor(60, 80, Config(), device="cpu")
    depth = small_depth()
    ex.process_depth(depth, SMALL_K)               # the stand-in's recording
    [spans] = traced_spans(lambda: ex.process_depth(depth, SMALL_K))
    inside = [("entry.key", "entry"), ("entry.load", "entry"), ("entry.replay", "entry"),
              ("entry.fresh", "entry")] if path == "stand_in" else []
    assert spans == [("io.upload", "call"), ("io.upload", "call"), ("entry", "call"), *inside,
                     ("io.download", "call")]


def test_a_replay_spans_key_load_replay_fresh_and_only_the_recording_captures(stand_in):
    """The resident entry (K already on the device: no upload): the first
    call runs eagerly and records inside its entry, the next two replay."""
    d = depth_tensor(small_depth()[None], "cpu")
    K = torch.as_tensor(SMALL_K)
    first, *replays = traced_spans(*[lambda: extract_depth_batch_jit(d, K, config=Config())] * 3)
    entry = [("entry", "call")]
    assert first == entry + [("entry.key", "entry"), ("entry.eager", "entry"),
                             ("entry.capture", "entry")]
    for spans in replays:
        assert spans == entry + [(name, "entry") for name in ("entry.key", "entry.load",
                                                              "entry.replay", "entry.fresh")]
    assert StandInGraph.made == 1
