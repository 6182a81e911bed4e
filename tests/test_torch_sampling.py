"""Stage 6's sampling (deplex_tpu_torch/kernels/sampling.py, csrc/sampling.cu)
against the composition it replaced and against the JAX package.

The kernel cannot run here, so its arithmetic is modelled in Python: the
cluster's split stable counting sort (each block of a frame's cluster owns
a span of cells, each of its warps a sub-span walked 32 cells at a time with
running per-id positions, each lane ranked among the equal ids of its step;
the blocks' per-id totals are exchanged, so each block knows its first
position for each id), its host launch plan, and the integer path of a
hypothesis with C's truncating division and the floor fix-ups the kernel
applies (32-bit where both operands lie in [0, 2^32)), with int64
wrap-around. Fed the same draws, the model, the plain twin and the JAX
package agree exactly: every quantity is an integer or a float32 formed in
the same order, so no tolerance is needed.
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

from .conftest import DATA
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


def cluster_sort(ids: np.ndarray, max_planes: int, C: int, warps: int = sampling.WARPS):
    """csrc/sampling.cu's sort of one frame's merged ids over a cluster of C
    blocks: (order (G,), start (MAXP+2,)). Block j owns the span of `span`
    cells from j * span (a multiple of 32), each warp a sub-span; pass one
    counts each warp's cells by id (the leaders' group sizes sum to the
    warp's counts), the blocks exchange their totals (each id's first
    position, and each block's offset: the totals of the blocks before it),
    and pass two walks each sub-span again 32 cells a step, writing each
    cell at its warp's running position for its id plus its rank among the
    equal ids before it in the step."""
    G, M = len(ids), max_planes
    span = sampling.span_cells(G, C)
    subs, hist = [], np.zeros((C, warps, M + 1), np.int64)
    for j in range(C):
        c_lo = min(G, j * span)
        c_hi = min(G, c_lo + span)
        sub = -(-(-(-(c_hi - c_lo) // warps)) // 32) * 32
        for w in range(warps):
            lo = min(c_hi, c_lo + w * sub)
            hi = min(c_hi, lo + sub)
            subs.append((j, w, lo, hi))
            hist[j, w] = np.bincount(ids[lo:hi], minlength=M + 1)       # pass one
    tot = hist.sum(1)                                       # each block's totals
    start = np.concatenate([[0], np.cumsum(tot.sum(0))])    # the exchange: bounds
    pre = np.cumsum(tot, 0) - tot                           # the blocks before
    first = start[:M + 1] + pre[:, None] + np.cumsum(hist, 1) - hist
    order = np.full(G, -1, np.int64)
    for j, w, lo, hi in subs:                               # pass two
        running = first[j, w].copy()
        for c0 in range(lo, hi, 32):
            cells = np.arange(c0, min(c0 + 32, hi))
            step = ids[cells]
            rank = np.tril(step[:, None] == step[None, :], -1).sum(1)
            pos = running[step] + rank
            assert (order[pos] == -1).all()                 # each position once
            order[pos] = cells
            np.add.at(running, step, 1)
    assert (order >= 0).all()
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
        order[b], bounds[b] = cluster_sort(cells[b], M, 4)
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
    for i in (1, 2):                             # the hypotheses and the winners
        torch.testing.assert_close(got[i], ref[i], rtol=0, atol=0)
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


def cluster_sort_grids():
    """Merged ids of grids of 3,072 (TUM, P=10), 19,200 (ICL ini, P=4),
    57,600 (720p, P=4) and 76,800 (VGA, P=2) cells: random ids with empty
    planes (ids past 40 unused), runs of equal ids, and all zero."""
    rng = np.random.default_rng(12)
    grids = {}
    for G in (3072, 19200, 57600, 76800):
        grids[f"random_{G}"] = rng.integers(0, 41, G)
        grids[f"runs_{G}"] = np.repeat(rng.integers(0, 65, -(-G // 300)), 300)[:G]
        grids[f"all_zero_{G}"] = np.zeros(G, np.int64)
    return grids


@pytest.mark.parametrize("C", sampling.CLUSTER_SIZES)
@pytest.mark.parametrize("grid", list(cluster_sort_grids()))
def test_the_clusters_split_sort_is_a_stable_argsort(grid, C):
    """The cluster's sort, at every cluster size, against
    torch.argsort(stable=True) and the twin's bounds (torch.searchsorted of
    the sorted ids); exact, the outputs are integers."""
    ids = cluster_sort_grids()[grid]
    order, start = cluster_sort(ids, 64, C)
    ref = torch.argsort(torch.from_numpy(ids), stable=True)
    np.testing.assert_array_equal(order, ref.numpy())
    _, counts, offsets = ransac._group_bounds(torch.from_numpy(ids), 64)
    bounds = torch.cat([offsets, offsets[-1:] + counts[-1:]])
    np.testing.assert_array_equal(start, bounds.numpy())


# --------------------------------------------------- the host launch plan

# Clusters of each size a card of 132 SMs runs at once (an occupancy table
# like the one cudaOccupancyMaxActiveClusters gives: a GPC holds one cluster
# of 16 blocks, and 7 of the card's do), and the fit blocks it runs at once
# (132 SMs x 5).
ACTIVE = {1: 264, 2: 132, 4: 60, 8: 30, 16: 7}
FIT_WAVE = 132 * 5


def test_the_launch_plan_runs_icl_p4_in_one_wave():
    """The ICL ini at P=4 (120x160 cells, 64 planes of 1024 slots), B=4:
    the sort on clusters of 16 blocks of 1,216 cells, 64 blocks in one wave;
    the fits on 4 x 128 blocks of 512 slots, one wave; a sort block's
    shared memory is its tables alone, whatever the grid."""
    plan = sampling.launch_plan(4, 120 * 160, 64 * 1024, ACTIVE, FIT_WAVE)
    assert plan == sampling.Plan(cluster=16, span=1216, blocks=64, waves=1, fit_blocks=512,
                                 fit_waves=1)
    assert plan.span * plan.cluster >= 120 * 160 > plan.span * (plan.cluster - 1)
    assert sampling.shared_bytes(64) == 5472 and sampling.shared_bytes(64, 16) == 9376


@pytest.mark.parametrize("B, cells, active, want", [
    (8, 3072, ACTIVE, (8, 8 * 8, 1, 1024, 2)),             # TUM B=8: 384 cells a block
    (1, 3072, ACTIVE, (8, 8, 1, 128, 1)),                  # B=1
    (1, 19200, ACTIVE, (16, 16, 1, 128, 1)),               # ICL's grid: 16 blocks
    (8, 19200, ACTIVE, (8, 64, 1, 1024, 2)),               # 7 clusters of 16 fit at once
    (64, 3072, ACTIVE, (2, 64 * 2, 1, 8192, 13)),          # the largest size in one wave
    (4, 19200, {**ACTIVE, 16: 0}, (8, 32, 1, 512, 1)),     # no cluster of 16 placed
    (600, 3072, ACTIVE, (1, 600, 3, 76800, 117)),          # no size in one wave
    (1, 300, ACTIVE, (1, 1, 1, 128, 1)),                   # fewer cells than MIN_SPAN
], ids=["tum_b8", "b1", "icl_b1", "icl_b8", "b64", "no_16", "past_one_wave", "small_grid"])
def test_the_launch_plan_picks_the_largest_cluster_in_one_wave(B, cells, active, want):
    plan = sampling.launch_plan(B, cells, 64 * 1024, active, FIT_WAVE)
    assert (plan.cluster, plan.blocks, plan.waves, plan.fit_blocks, plan.fit_waves) == want
    assert plan.cluster == 1 or -(-cells // plan.cluster) >= sampling.MIN_SPAN


@pytest.mark.parametrize("slots", [1, 511, 512, 64 * 1024, 32 * 1024 + 7], ids=str)
def test_the_fit_blocks_cover_every_slot_once(slots):
    """csrc/sampling.cu's fit blocks: block x takes the FIT_SLOTS slots from
    x * FIT_SLOTS, thread t the slots t + s * FIT_THREADS of them (s < 2);
    every slot of the frame written once, by as many blocks as the plan
    launches."""
    seen = np.zeros(slots, np.int64)
    blocks = sampling.launch_plan(1, 3072, slots, ACTIVE, FIT_WAVE).fit_blocks
    T = sampling.FIT_THREADS
    assert sampling.FIT_SLOTS == 2 * T
    for x in range(blocks):
        for s in range(2):
            hs = x * sampling.FIT_SLOTS + np.arange(T) + s * T
            seen[hs[hs < slots]] += 1
    assert (seen == 1).all()
    assert (blocks - 1) * sampling.FIT_SLOTS < slots <= blocks * sampling.FIT_SLOTS


def test_the_launch_plan_raises_without_a_cluster():
    with pytest.raises(RuntimeError, match="no cluster"):
        sampling.launch_plan(1, 3072, 1024, {C: 0 for C in sampling.CLUSTER_SIZES}, FIT_WAVE)


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
    # With raw numbers, a plane with no cell draws one pixel thrice: all its
    # slots are the padding, which the kernel writes without a load.
    empty = counts == 0
    assert empty.any() and (hyp[empty] == [0, 0, 0, np.float32(1e30)]).all()


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


def quot_small(a: int, c: int) -> int:
    """csrc/sampling.cu's quot_small: the quotient from a * (1/c) in double,
    truncated, then one correction step."""
    q = int(float(a) * (1.0 / c))
    r = a - q * c
    return q - 1 if r < 0 else q + 1 if r >= c else q


def test_the_reciprocal_quotient_is_the_floor():
    """For 0 <= a < 2^32 and 1 <= c < 2^32 the kernel's division-free
    quotient is floor(a / c) exactly: near multiples of c, at the ends of
    the range, and on random pairs (the fits' ranks, cells and pixels)."""
    rng = np.random.default_rng(13)
    cs = [1, 2, 3, 7, 10, 100, 160, 320, 12800, 2 ** 19 + 1, 2 ** 31 - 1, 2 ** 32 - 1]
    cs += [int(c) for c in rng.integers(1, 2 ** 32, 200)]
    for c in cs:
        edge = [0, 1, c - 1, c, c + 1, 2 ** 32 - 1]
        edge += [k * c + d for k in (2, 1000, (2 ** 32 - 1) // c) for d in (-1, 0, 1)]
        edge += [int(a) for a in rng.integers(0, 2 ** 32, 50)]
        for a in edge:
            if 0 <= a < 2 ** 32:
                assert quot_small(a, c) == a // c, (a, c)


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
        # Past 2^30 cells a frame, the kernel's integer limit: only the
        # card's path checks it (the twin takes any grid, test below).
        with pytest.raises(ValueError, match="sample"):
            sampling.check_launch(1, (1 << 30) + 1, 1 << 30, cfg)
        return
    else:
        lm = lm.transpose(1, 2)
    with pytest.raises(ValueError, match="sample"):
        sampling.sample(pts, lm, ml, W, P, cfg)


def test_the_shared_memory_limit_admits_the_shipped_grids():
    """The ICL ini's P=4 grid (120x160 = 19,200 cells), 720p at P=8 (90x160)
    and P=4 (180x320) and VGA at P=2 (240x320) fit a block, and so does
    every grid: a sort block holds its tables alone. Only MAXP past 2,766
    is refused."""
    for cells in (48 * 64, 120 * 160, 90 * 160, 180 * 320, 240 * 320, 1 << 30):
        sampling.check_launch(1, cells, 1280 * 720, Config(ransac_refinement=True))
    assert sampling.shared_bytes(64) <= sampling.shared_bytes(2766) <= \
        sampling.MAX_SHARED_BYTES < sampling.shared_bytes(2767)
    with pytest.raises(ValueError, match="shared memory"):
        sampling.check_launch(1, 3072, 307200, Config(max_planes=2767))


@pytest.mark.parametrize("C", sampling.CLUSTER_SIZES)
@pytest.mark.parametrize("M", [1, 8, 64, 1024])
def test_the_sort_blocks_tables_fit_their_shared_memory(M, C):
    """csrc/sampling.cu's sort block lays out, in order: the LUT (M+1), 16
    warps' counts (16 x (M+1)), every block's pushed totals (C x (M+1)), its
    offsets (M+1), the frame's counts (M+1) and the first positions (M+2);
    shared_bytes holds them all, rounded up to 16 bytes."""
    ints = (M + 1) + 16 * (M + 1) + C * (M + 1) + (M + 1) + (M + 1) + (M + 2)
    assert sampling.shared_bytes(M, C) == -(-4 * ints // 16) * 16


def test_the_wrapper_takes_any_grid_on_the_cpu():
    """A 76,800-cell grid (VGA at P=2), past the old kernel's shared-memory
    limit even at MAXP 8: the wrapper runs the twin on the CPU."""
    rng = np.random.default_rng(9)
    lm, ml, pts = merge_case(rng, 1, 240, 320, 8, P=2)
    cfg = Config(patch_size=2, max_planes=8, ransac_refinement=True, ransac_max_iterations=16)
    got = sampling.sample(*as_torch(pts, lm, ml), 640, 2, cfg)
    assert_sampling_equal(got, ransac.sample_stage_reference(*as_torch(pts, lm, ml), 640, 2,
                                                            cfg))


def test_stage6_on_a_76800_cell_grid_equals_jax_with_its_draws(monkeypatch):
    """The depth entry's stages 1-4 on the ICL frame at P=2 (240x320 =
    76,800 cells, past the old kernel's limit at any MAXP), then stage 6
    through refine_stage (the sampling and chunk-step wrappers, the labels
    wrapper's final pass; their twins here), fed the JAX package's draws:
    the labels equal the JAX package's refine_labels on the same merged cell
    labels; exact (integer labels)."""
    from deplex_tpu.ops.merge import rasterize_labels as jax_rasterize
    from deplex_tpu_torch.pipeline import (depth_tensor, intrinsics_tensor, plane_stages,
                                           refine_stage)
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    depth = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    K = read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))
    keys = dict(patch_size=2, max_planes=8, ransac_refinement=True, ransac_max_iterations=16)
    ini = str(DATA / "configs" / "ICL_living_room.ini")
    cfg, cfg_j = Config.from_ini(ini).replace(**keys), JaxConfig.from_ini(ini).replace(**keys)
    H, W, P = depth.height, depth.width, 2
    planes = plane_stages(depth_tensor(depth.data[None], "cpu"), intrinsics_tensor(K, "cpu"),
                          cfg)
    assert planes.labels_map.shape == (1, 240, 320)
    merged = apply_label_lut(planes.labels_map, planes.merge_labels)[0].numpy()
    pts = planes.points[0].numpy()
    labels_j = jax_rasterize(jnp.asarray(planes.labels_map[0].numpy()),
                             jnp.asarray(planes.merge_labels[0].numpy()), H, W, P)
    ref = np.asarray(jransac.refine_labels(jnp.asarray(pts), labels_j, cfg_j,
                                           cell_labels=jnp.asarray(merged), image_width=W,
                                           patch_size=P))
    counts = np.bincount(merged.ravel(), minlength=9)[1:] * P * P
    draws = jax_draws(counts, 8, 16)
    monkeypatch.setattr(ransac, "draw_ranks", lambda *args, **kwargs: draws)
    got, scored = refine_stage(planes, H, W, cfg)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    assert int(scored[0]) >= 1
    assert 0 < int((ref > 0).sum()) < int((np.asarray(labels_j) > 0).sum())
    assert (counts > 0).sum() >= 6
