"""Stage 6's sampling (deplex_tpu_torch/kernels/sampling.py, csrc/sampling.cu)
against the composition it replaced and against the JAX package.

The kernel cannot run here, so its arithmetic is modelled in Python: the
tiled, warp-ranked stable counting sort (each warp walks its span of cells
32 at a time, ranks each lane among the equal ids of its step, counts by id,
then writes each cell at its warp's first position plus its rank) and the
integer path of a hypothesis with C's truncating division and the floor
fix-ups the kernel applies (32-bit where both operands lie in [0, 2^32)),
with int64 wrap-around. Fed the same draws, the model, the plain twin and
the JAX package agree exactly: every quantity is an integer or a float32
formed in the same order, so no tolerance is needed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu import Config as JaxConfig
from deplex_tpu.ops import ransac as jransac
from deplex_tpu_torch import Config, kernels
from deplex_tpu_torch.kernels import sampling
from deplex_tpu_torch.ops import ransac
from deplex_tpu_torch.ops.merge import apply_label_lut

from .test_torch_ransac import chunk_scene, jax_draws, scene_config


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ the kernel's model

I64 = 1 << 64


def wrap(x: int) -> int:
    """x as an int64 wraps."""
    x %= I64
    return x - I64 if x >= 1 << 63 else x


def c_div(a: int, c: int) -> int:
    """C's truncating a / c."""
    q = abs(a) // abs(c)
    return q if (a >= 0) == (c > 0) else -q


def small(a: int) -> bool:
    return 0 <= a < 1 << 32


def floor_mod(a: int, c: int) -> int:
    """csrc/sampling.cu's floor_mod (c >= 1)."""
    if small(a) and small(c):
        return a % c
    r = a - c_div(a, c) * c
    return r + c if r < 0 else r


def floor_div(a: int, c: int) -> int:
    """csrc/sampling.cu's floor_div (c >= 1)."""
    if small(a) and small(c):
        return a // c
    q = c_div(a, c)
    return q - 1 if (a - q * c) != 0 and a < 0 else q


def kernel_sort(ids: np.ndarray, max_planes: int, warps: int = sampling.WARPS):
    """The kernel's counting sort of one frame's merged ids: (order (G,),
    start (MAXP+2,)), start[m] the number of ids below m."""
    G, M = len(ids), max_planes
    span = ((G + warps - 1) // warps + 31) // 32 * 32
    hist = np.zeros((warps, M + 1), np.int64)

    def steps(w):
        lo = min(G, w * span)
        hi = min(G, lo + span)
        for c0 in range(lo, hi, 32):
            cells = np.arange(c0, c0 + 32)
            lane_ids = np.where(cells < hi, ids[np.minimum(cells, G - 1)], -1)
            yield cells, lane_ids

    for w in range(warps):                       # pass one: each warp's counts
        for _, lane_ids in steps(w):
            for i in np.unique(lane_ids[lane_ids >= 0]):
                hist[w, i] += int((lane_ids == i).sum())     # the group's leader
    total = hist.sum(0)
    start = np.concatenate([[0], np.cumsum(total)])
    first = np.cumsum(hist, 0) - hist + start[:M + 1]       # scans over warps and ids
    order = np.full(G, -1, np.int64)
    for w in range(warps):                       # pass two: position plus rank
        for cells, lane_ids in steps(w):
            for lane in range(32):
                i = lane_ids[lane]
                if i >= 0:
                    order[first[w, i] + int((lane_ids[:lane] == i).sum())] = cells[lane]
            for i in np.unique(lane_ids[lane_ids >= 0]):
                first[w, i] += int((lane_ids == i).sum())
    return order, start


def kernel_model(points, labels_map, merge_labels, W, P, config, *, draws=None, raw=None,
                 chunk_size=None):
    """The kernel's outputs from numpy inputs: (cells, order, bounds, counts,
    hyp); draws (MAXP, K, 3) or (B, MAXP, K, 3) ranks, else raw numbers."""
    B, gh, gw = labels_map.shape
    G, M, K, PP = gh * gw, config.max_planes, config.ransac_max_iterations, P * P
    Kc, S = ransac.chunk_plan(K, chunk_size)
    cells = np.zeros((B, G), np.int32)
    order = np.zeros((B, G), np.int64)
    bounds = np.zeros((B, M + 2), np.int64)
    pix = np.zeros((B, M, K, 3), np.int64)
    for b in range(B):
        lut = np.arange(M + 1) if merge_labels is None else \
            np.concatenate([[0], merge_labels[b].astype(np.int64) + 1])
        lut = np.where((lut < 0) | (lut > M), 0, lut)
        lab = labels_map[b].reshape(-1).astype(np.int64)
        cells[b] = np.where((lab < 0) | (lab > M), 0, lut[np.clip(lab, 0, M)])
        order[b], bounds[b] = kernel_sort(cells[b], M)
        u_frame = raw if draws is None else (draws if draws.ndim == 3 else draws[b])
        for p in range(M):
            first = int(bounds[b, p + 1])
            c = max(int(bounds[b, p + 2] - bounds[b, p + 1]) * PP, 1)
            for k in range(K):
                u0, u1, u2 = (int(v) for v in u_frame[p, k])
                if draws is None:
                    u0, u1, u2 = floor_mod(u0, c), floor_mod(u1, c), floor_mod(u2, c)
                v1 = wrap(u1 + (u1 == u0))
                v2 = wrap(wrap(u2 + (u2 == u0)) + (v1 == u2))
                for j, idx in enumerate((u0, floor_mod(v1, c), floor_mod(v2, c))):
                    crank = floor_div(idx, PP)
                    t = wrap(idx - crank * PP)
                    pos = min(max(wrap(first + crank), 0), G - 1)
                    row, col = divmod(int(order[b, pos]), gw)
                    pix[b, p, k, j] = (row * P + t // P) * W + col * P + t % P
    counts = np.diff(bounds, axis=1)[:, 1:] * PP
    q = points[np.arange(B)[:, None], pix.reshape(B, -1)].reshape(B, M, K, 3, 3)
    with np.errstate(all="ignore"):
        a, bb = q[..., 1, :] - q[..., 0, :], q[..., 2, :] - q[..., 0, :]
        n0 = a[..., 1] * bb[..., 2] - a[..., 2] * bb[..., 1]
        n1 = a[..., 2] * bb[..., 0] - a[..., 0] * bb[..., 2]
        n2 = a[..., 0] * bb[..., 1] - a[..., 1] * bb[..., 0]
        nrm = np.sqrt((n0 * n0 + n1 * n1 + n2 * n2).astype(np.float64)).astype(np.float32)
        m0, m1, m2 = n0 / nrm, n1 / nrm, n2 / nrm
        p0 = q[..., 0, :]
        d = -(m0 * p0[..., 0] + m1 * p0[..., 1] + m2 * p0[..., 2])
    fit = np.stack([m0, m1, m2, d], -1)
    good = np.isfinite(fit).all(-1, keepdims=True)
    hyp = np.zeros((B, M, S * Kc, 4), np.float32)
    hyp[..., 3] = np.float32(1e30)
    hyp[:, :, :K] = np.where(good, fit, hyp[:, :, :K])
    return cells.reshape(B, gh, gw), order, bounds, counts, hyp


# ------------------------------------------------------------------- inputs

def merge_case(rng, B, gh, gw, M, H=None, W=None, P=8):
    """Seeded (labels_map, merge_labels, points): cell labels in 0..M, each
    merge label a plane at or before its row (as K3 merges), points of a
    tilted plane with noise on an H x W image holding the gh*P x gw*P crop."""
    H, W = H or gh * P, W or gw * P
    lm = rng.integers(0, M + 1, (B, gh, gw)).astype(np.int32)
    ml = np.stack([[int(rng.integers(0, i + 1)) if rng.random() < 0.3 else i
                    for i in range(M)] for _ in range(B)]).astype(np.int32)
    v, u = np.mgrid[:H, :W].astype(np.float32)
    z = 2000 + 3 * u + 2 * v
    pts = np.stack([(u - W / 2) * z / 500, (v - H / 2) * z / 500, z], -1)
    pts = pts + rng.normal(0, 5, (B, H, W, 3))
    return lm, ml, pts.reshape(B, H * W, 3).astype(np.float32)


def tum_grid_case(rng, B=1):
    """The TUM ini's grid: 48x64 cells of 10 pixels, 64 planes, 480x640."""
    return merge_case(rng, B, 48, 64, 64, P=10)


def as_torch(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def assert_sampling_equal(got: ransac.Sampling, ref: ransac.Sampling):
    assert (got.chunk, got.chunks) == (ref.chunk, ref.chunks)
    for name in ("cells", "hyp", "counts", "cell_order", "bounds"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    for name, a, b in zip(ransac.ChunkState._fields, got.state, ref.state):
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def composition(points, lm, ml, W, P, cfg, **kw) -> ransac.Sampling:
    """What refine_cells composed before the sampler: apply_label_lut,
    sample_hypotheses, new_chunk_state."""
    cells = apply_label_lut(lm, ml)
    hyp, counts, order, bounds, Kc, S = ransac.sample_hypotheses(points, cells, W, P, cfg, **kw)
    ratio = torch.full((), cfg.ransac_inliers_ratio, dtype=torch.float32)
    return ransac.Sampling(cells, hyp, counts, order, bounds,
                           ransac.new_chunk_state(counts.to(torch.float32), ratio, Kc), Kc, S)


def recording(log: list):
    """kernels.sampling.sample, a copy of its outputs kept in `log` (the
    loop updates the state in place)."""
    def sample(*args, **kwargs):
        out = sampling.sample(*args, **kwargs)
        log.append(out._replace(state=ransac.ChunkState(*(t.clone() for t in out.state))))
        return out
    return sample


# --------------------------------------------------- the twin, through refine_cells

@pytest.mark.parametrize("case", ["chunk_scene", "tum_grid"])
def test_the_sampler_through_refine_cells_is_the_old_composition(case):
    """refine_cells(sample=...) with round finalize's labels and K3's merge
    labels: the sampler's hyp, order, bounds, counts and state equal the
    composition refine_cells made before, and so do the labels."""
    rng = np.random.default_rng(5)
    if case == "chunk_scene":
        pts, _, cell_lab, W, P = chunk_scene()
        cfg = scene_config(0.15)
        lm = cell_lab[None].astype(np.int32)
        ml = np.array([[0, 0, 2, 3]], np.int32)            # plane 2 merged into plane 1
        pts = pts[None]
        chunk = 64
    else:
        lm, ml, pts = tum_grid_case(rng, B=2)
        cfg = Config(ransac_refinement=True, ransac_max_iterations=40,
                     ransac_inliers_ratio=0.15, ransac_threshold=20.0)
        W, P, chunk = 640, 10, None
    pts_t, lm_t, ml_t = as_torch(pts, lm, ml)
    log = []
    got, got_scored = ransac.refine_cells(pts_t, None, lm_t, W, P, cfg, merge_labels=ml_t,
                                          sample=recording(log), chunk_size=chunk,
                                          write=lambda *w: w)
    assert_sampling_equal(log[0], composition(pts_t, lm_t, ml_t, W, P, cfg, chunk_size=chunk))
    ref, ref_scored = ransac.refine_cells(pts_t, None, apply_label_lut(lm_t, ml_t), W, P, cfg,
                                          chunk_size=chunk, write=lambda *w: w)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)      # the winners
    assert torch.equal(got_scored, ref_scored)


@pytest.mark.parametrize("ratio", [0.15, 0.5, 1.0])
def test_the_sampled_cell_path_equals_jax_with_its_draws(ratio):
    """The pipeline's form, refine_cells on round finalize's labels with
    K3's merge labels through kernels.sampling.sample, against the JAX
    package's refine_labels on the merged cell labels, fed its draws:
    equal labels."""
    pts, labels, cell_lab, W, P = chunk_scene(seed=11)
    ml = np.array([0, 1, 1, 3], np.int32)                   # plane 3 merged into plane 2
    merged = np.concatenate([[0], ml + 1])[cell_lab].astype(np.int32)
    labels = np.repeat(np.repeat(merged, P, 0), P, 1).reshape(-1)
    ref = np.asarray(jransac.refine_labels(
        jnp.asarray(pts), jnp.asarray(labels), scene_config(ratio, JaxConfig),
        cell_labels=jnp.asarray(merged), image_width=W, patch_size=P, chunk_size=64))
    counts = np.bincount(merged.ravel(), minlength=5)[1:] * P * P
    got, _ = ransac.refine_cells(
        torch.from_numpy(pts)[None], torch.from_numpy(labels)[None],
        torch.from_numpy(cell_lab.astype(np.int32))[None], W, P, scene_config(ratio),
        merge_labels=torch.from_numpy(ml)[None], sample=sampling.sample,
        draws=jax_draws(counts, 4, 192), chunk_size=64)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    assert 0 < int((ref > 0).sum()) < int((labels > 0).sum())


# --------------------------------------------------- the kernel's counting sort

def sort_cases():
    rng = np.random.default_rng(2)
    M = 64
    every = np.concatenate([np.arange(M + 1), rng.integers(0, M + 1, 3072 - M - 1)])
    return {
        "random_tum_grid": (rng.integers(0, M + 1, 3072), M),
        "random_few_ids": (rng.integers(0, 4, 3072), M),
        "all_zero": (np.zeros(3072, np.int64), M),
        "one_plane_holds_every_cell": (np.full(3072, 17), M),
        "every_id_present": (rng.permutation(every), M),
        "g_not_a_multiple_of_the_tile_7x13": (rng.integers(0, 9, 91), 8),
        "g_one_cell": (np.array([3]), 4),
        "g_past_the_warp_spans_4999": (rng.integers(0, M + 1, 4999), M),
        "runs_of_equal_ids": (np.repeat(rng.integers(0, M + 1, 40), 77), M),
    }


@pytest.mark.parametrize("name", list(sort_cases()))
def test_the_kernels_counting_sort_is_a_stable_argsort(name):
    ids, M = sort_cases()[name]
    order, start = kernel_sort(ids, M)
    ref = torch.argsort(torch.from_numpy(ids), stable=True).numpy()
    np.testing.assert_array_equal(order, ref)
    np.testing.assert_array_equal(order, np.argsort(ids, kind="stable"))
    marks = torch.arange(M + 2, dtype=torch.int64)
    np.testing.assert_array_equal(
        start, torch.searchsorted(torch.from_numpy(ids[ref]), marks).numpy())


# --------------------------------------------------- the kernel's arithmetic

def test_the_kernel_model_equals_the_twin_under_the_default_stream():
    """The model of the whole kernel (sort, ranks from the raw numbers,
    fits, padding) against the twin on a TUM-grid batch of two."""
    rng = np.random.default_rng(8)
    lm, ml, pts = tum_grid_case(rng, B=2)
    cfg = Config(ransac_refinement=True, ransac_max_iterations=60)
    raw = ransac.default_draws(cfg, "cpu")
    ref = ransac.sample_stage_reference(*as_torch(pts, lm, ml), 640, 10, cfg, chunk_size=16)
    cells, order, bounds, counts, hyp = kernel_model(pts, lm, ml, 640, 10, cfg,
                                                     raw=raw.numpy(), chunk_size=16)
    for got, want in ((cells, ref.cells), (order, ref.cell_order), (bounds, ref.bounds),
                      (counts, ref.counts)):
        np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(hyp.view(np.uint32), ref.hyp.numpy().view(np.uint32))
    assert (hyp[..., 60:, 3] == np.float32(1e30)).all()      # the padded slots


@pytest.mark.parametrize("batched", [False, True])
def test_negative_and_out_of_range_draws_follow_the_twins_floor_semantics(batched):
    """Caller ranks the twin takes as they are: negative, past the plane's
    pixels, past 2^32, at the int64 limits (the +1 of the de-duplicating
    shift wraps). The kernel's truncating divisions with their fix-ups give
    the twin's floor divisions and moduli, so the same cells, pixels and
    fits; a plane with no cells (several here) clamps into another's cell."""
    rng = np.random.default_rng(4)
    B, M, K = 2, 6, 40
    lm, ml, pts = merge_case(rng, B, 5, 7, M, P=4)
    lm[:, :, :3] = 0
    lm[lm > 3] = 1                                          # planes 4-6 hold no cell
    cfg = Config(patch_size=4, max_planes=M, ransac_refinement=True, ransac_max_iterations=K)
    special = np.array([-1, -15, -16, -17, 2 ** 32, 2 ** 32 + 5, -(2 ** 40) - 3, 2 ** 63 - 1,
                        -(2 ** 63), 2 ** 63 - 2, 10 ** 6, 0], np.int64)
    shape = (B, M, K, 3) if batched else (M, K, 3)
    draws = rng.integers(-300, 300, shape).astype(np.int64)
    flat = draws.reshape(-1, 3)
    pick = rng.choice(len(flat), 200, replace=False)
    flat[pick] = rng.choice(special, (200, 3))
    flat[:3] = [[2 ** 63 - 1, 2 ** 63 - 1, 2 ** 63 - 1], [5, 5, 5], [-7, -7, -6]]
    ref = ransac.sample_stage_reference(*as_torch(pts, lm, ml), 7 * 4, 4, cfg,
                                        draws=torch.from_numpy(draws), chunk_size=16)
    cells, order, bounds, counts, hyp = kernel_model(pts, lm, ml, 28, 4, cfg, draws=draws,
                                                     chunk_size=16)
    np.testing.assert_array_equal(order, ref.cell_order.numpy())
    np.testing.assert_array_equal(counts, ref.counts.numpy())
    np.testing.assert_array_equal(hyp.view(np.uint32), ref.hyp.numpy().view(np.uint32))
    assert (counts[:, 3:] == 0).all()
    assert (hyp[:, 3:, :K] == [0, 0, 0, np.float32(1e30)]).all()    # degenerate triples


def test_the_python_floor_helpers_are_torchs():
    """The model's C-style helpers against torch's int64 // and %."""
    a = np.array([-(2 ** 63), -(2 ** 40) - 3, -17, -16, -1, 0, 1, 15, 16, 2 ** 32 - 1, 2 ** 32,
                  2 ** 40 + 7, 2 ** 63 - 1], np.int64)
    for c in (1, 3, 16, 100, 2 ** 31 - 1, 2 ** 32 + 1):
        t = torch.from_numpy(a)
        assert [floor_div(int(x), c) for x in a] == (t // c).tolist()
        assert [floor_mod(int(x), c) for x in a] == (t % c).tolist()


# ------------------------------------------------------------------ the wrapper

def test_the_wrapper_runs_the_twin_on_the_cpu_and_counts_no_launch():
    rng = np.random.default_rng(6)
    lm, ml, pts = merge_case(rng, 2, 6, 9, 8)
    cfg = Config(max_planes=8, ransac_refinement=True, ransac_max_iterations=150)
    kernels.reset_launch_counts()
    got = sampling.sample(*as_torch(pts, lm, ml), 72, 8, cfg)
    assert kernels.launch_counts()["ransac_sampling"] == 0
    assert "ransac_sampling" in kernels.MODULES and \
        "ransac_sampling" not in kernels.PLANE_KERNELS
    assert_sampling_equal(got, ransac.sample_stage_reference(*as_torch(pts, lm, ml), 72, 8, cfg))
    assert got.hyp.shape == (2, 8, 256, 4) and (got.chunk, got.chunks) == (128, 2)
    # Labels merged already: no merge labels.
    merged = apply_label_lut(*as_torch(lm, ml))
    assert_sampling_equal(sampling.sample(torch.from_numpy(pts), merged, None, 72, 8, cfg), got)


@pytest.mark.parametrize("fault", ["labels_dtype", "labels_shape", "merge_dtype", "merge_shape",
                                   "points_dtype", "points_width", "grid_past_the_image",
                                   "too_large_g", "not_contiguous"])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(fault):
    rng = np.random.default_rng(7)
    lm, ml, pts = as_torch(*merge_case(rng, 2, 6, 9, 8))
    cfg = Config(max_planes=8, ransac_refinement=True, ransac_max_iterations=70)
    W, P = 72, 8
    if fault == "labels_dtype":
        lm = lm.long()
    elif fault == "labels_shape":
        lm = lm.reshape(2, -1)
    elif fault == "merge_dtype":
        ml = ml.long()
    elif fault == "merge_shape":
        ml = ml[:, :5].contiguous()
    elif fault == "points_dtype":
        pts = pts.double()
    elif fault == "points_width":
        W = 70
    elif fault == "grid_past_the_image":
        P = 9
    elif fault == "too_large_g":
        # 200 x 200 cells of one pixel: the sort takes 240,652 bytes of
        # shared memory, past the 232,448 a block may hold.
        lm = torch.zeros((1, 200, 200), dtype=torch.int32)
        ml, pts, W, P = ml[:1], torch.zeros((1, 200 * 200, 3)), 200, 1
        assert sampling.shared_bytes(200 * 200, 8) > sampling.MAX_SHARED_BYTES
    else:
        lm = lm.transpose(1, 2)
    with pytest.raises(ValueError, match="sample"):
        sampling.sample(pts, lm, ml, W, P, cfg)


def test_the_shared_memory_limit_admits_the_shipped_grids():
    """The ICL ini's P=4 grid (120x160 = 19,200 cells) and 720p at P=8
    (90x160) fit a block; the limit ROADMAP records is past them."""
    for cells in (48 * 64, 120 * 160, 90 * 160):
        assert sampling.shared_bytes(cells, 64) <= sampling.MAX_SHARED_BYTES
