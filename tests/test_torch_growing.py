"""Stage 3 of deplex_tpu_torch (the CPU twin of the growing kernel) vs
deplex_tpu's grow_rounds + finalize_rounds, fed the reference's own CellStats.

Discrete outputs must be equal: bins, edges, round_map, nr_rounds,
labels_map, nr_planes. Per-round counts and coordinate sums agree to rtol
1e-4 / atol 1.0 (as in tests/test_pallas_batched.py; the one-hot products
reduce in another order), per-round scatters to 1e-4 of their trace;
segment stats to rtol 1e-4 and normals to 1e-4 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu import Config as JaxConfig
from deplex_tpu.ops.cellstats import compute_cell_stats as jax_compute_cell_stats
from deplex_tpu.ops.growing import admissibility_edges as jax_edges
from deplex_tpu.ops.growing import finalize_rounds as jax_finalize
from deplex_tpu.ops.growing import flood_fill as jax_flood_fill
from deplex_tpu.ops.growing import grow_rounds as jax_grow_rounds
from deplex_tpu.ops.growing import region_sums as jax_region_sums
from deplex_tpu.ops.histogram import normal_bins as jax_normal_bins
from deplex_tpu_torch import interop
from deplex_tpu_torch.ops import growing
from deplex_tpu_torch.ops.histogram import histogram_counts, normal_bins

from .conftest import DATA


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_case(pts_batch, H, W, jcfg):
    """Reference stats, rounds and finalize for a batch of clouds (jitted)."""
    @jax.jit
    def run(p):
        stats = jax.vmap(lambda q: jax_compute_cell_stats(q, H, W, jcfg))(p)
        rounds = jax.vmap(lambda s: jax_grow_rounds(s, jcfg))(stats)
        lm, seg = jax.vmap(lambda r: jax_finalize(r, jcfg))(rounds)
        bins = jax.vmap(lambda s: jax_normal_bins(s.normal, s.planar,
                                                  jcfg.histogram_bins_per_coord))(stats)
        edges = jax.vmap(lambda s: jax_edges(s, jcfg))(stats)
        return stats, rounds, lm, seg, bins, edges
    return run(jnp.asarray(pts_batch))


def _assert_sums_close(got, ref):
    """RoundData.sums rows: [n, sx, sy, sz, 6 scatter entries, size, 0...]."""
    cols = [0, 1, 2, 3, 10]
    np.testing.assert_allclose(got[..., cols], ref[..., cols], rtol=1e-4, atol=1.0)
    trace = ref[..., 4] + ref[..., 7] + ref[..., 9]
    err = np.abs(got[..., 4:10] - ref[..., 4:10])
    assert (err <= 1e-4 * np.abs(trace)[..., None] + 1.0).all(), float(err.max())


def _case(name, tum_cloud):
    if name == "tum":
        pts, h, w = tum_cloud
        return pts[None], h, w, JaxConfig()
    if name == "icl":
        from deplex_tpu.utils import DepthImage, read_intrinsics

        img = DepthImage(str(DATA / "icl_nuim" / "0.png"))
        K = read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))
        jcfg = JaxConfig.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
        return img.transform_to_pcd(K)[None], img.height, img.width, jcfg
    if name == "empty":
        return np.zeros((1, 480 * 640, 3), np.float32), 480, 640, JaxConfig()
    # Mixed round counts: four quadrants of the TUM frame in one batch.
    pts, h, w = tum_cloud
    img = pts.reshape(h, w, 3)
    crops = [img[:240, :320], img[240:, :320], img[:240, 320:], img[240:, 320:]]
    return (np.stack([c.reshape(-1, 3) for c in crops]), 240, 320,
            JaxConfig(max_region_growing_rounds=128))


@pytest.mark.parametrize("name", ["tum", "icl", "empty", "mixed_rounds"])
def test_growing_matches_jax(tum_cloud, name):
    pts, H, W, jcfg = _case(name, tum_cloud)
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    stats_j, rounds_j, lm_j, seg_j, bins_j, edges_j = _jax_case(pts, H, W, jcfg)
    stats = interop.cell_stats_from_numpy(interop.fields_of(stats_j))

    bins = normal_bins(stats.normal, stats.planar, cfg.histogram_bins_per_coord)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(bins_j))
    edges = growing.admissibility_edges(stats, cfg)
    for k in growing.EDGE_NAMES:
        np.testing.assert_array_equal(edges[k].numpy(), np.asarray(edges_j[k]), err_msg=k)

    rounds = growing.grow_rounds(stats, cfg)
    np.testing.assert_array_equal(rounds.nr_rounds.numpy(), np.asarray(rounds_j.nr_rounds))
    np.testing.assert_array_equal(rounds.round_map.numpy(), np.asarray(rounds_j.round_map))
    _assert_sums_close(rounds.sums.numpy(), np.asarray(rounds_j.sums))

    lm, seg = growing.finalize_rounds(rounds, cfg)
    np.testing.assert_array_equal(lm.numpy(), np.asarray(lm_j))
    # Fed the reference's own rounds, finalize gives its labels and slots.
    lm_fed, seg_fed = growing.finalize_rounds(
        interop.round_data_from_numpy(interop.fields_of(rounds_j)), cfg)
    np.testing.assert_array_equal(lm_fed.numpy(), np.asarray(lm_j))
    np.testing.assert_array_equal(seg_fed.nr_planes.numpy(), np.asarray(seg_j.nr_planes))
    np.testing.assert_array_equal(seg.nr_planes.numpy(), np.asarray(seg_j.nr_planes))
    for f in ("n", "coord_sum", "mean", "d", "score"):
        np.testing.assert_allclose(getattr(seg, f).numpy(), np.asarray(getattr(seg_j, f)),
                                   rtol=1e-4, atol=1e-3, err_msg=f)
    np.testing.assert_allclose(seg.normal.numpy(), np.asarray(seg_j.normal), rtol=0, atol=1e-4)
    tr = np.trace(np.asarray(seg_j.scatter), axis1=-2, axis2=-1)
    assert (np.abs(seg.scatter.numpy() - np.asarray(seg_j.scatter))
            <= 1e-4 * tr[..., None, None] + 1e-2).all()
    if name == "empty":
        assert int(rounds.nr_rounds[0]) == 0 and bool((rounds.round_map == -1).all())
    if name == "mixed_rounds":
        assert len(set(rounds.nr_rounds.tolist())) > 1


def test_region_sums_match_jax(tum_cloud):
    """Same round map and seeds into both region_sums."""
    pts, H, W, jcfg = _case("tum", tum_cloud)
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    stats_j = jax.jit(lambda p: jax_compute_cell_stats(p, H, W, jcfg))(jnp.asarray(pts[0]))
    stats = interop.cell_stats_from_numpy(interop.fields_of(stats_j), add_batch_axis=True)
    bins = normal_bins(stats.normal, stats.planar, cfg.histogram_bins_per_coord)
    round_map, seeds, nr = growing.grow_rounds_loop(
        bins, stats.mse, growing.admissibility_edges(stats, cfg), stats.planar, cfg)
    assert int(nr[0]) > 10
    got = growing.region_sums(round_map, seeds, stats, cfg.max_region_growing_rounds)
    ref = jax.jit(lambda rm, sd, s: jax_region_sums(rm, sd, s, cfg.max_region_growing_rounds))(
        jnp.asarray(round_map[0].numpy()), jnp.asarray(seeds[0].numpy()), stats_j)
    _assert_sums_close(got[0].numpy(), np.asarray(ref))


def test_flood_fill_matches_jax():
    rng = np.random.default_rng(5)
    B, gh, gw = 3, 17, 23
    edges_np = {k: rng.random((B, gh, gw)) < 0.7 for k in growing.EDGE_NAMES}
    for k, (axis, first) in zip(growing.EDGE_NAMES, ((0, True), (0, False), (1, True), (1, False))):
        idx = [slice(None)] * 2
        idx[axis] = 0 if first else -1
        for b in range(B):
            edges_np[k][b][tuple(idx)] = False
    allowed = rng.random((B, gh, gw)) < 0.8
    seed = np.zeros((B, gh, gw), bool)
    seed[:, gh // 2, gw // 2] = True
    seed &= allowed
    got = growing.flood_fill(torch.from_numpy(seed), torch.from_numpy(allowed),
                             {k: torch.from_numpy(v) for k, v in edges_np.items()})
    for b in range(B):
        ref = jax_flood_fill(jnp.asarray(seed[b]), jnp.asarray(allowed[b]),
                             {k: jnp.asarray(v[b]) for k, v in edges_np.items()})
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


def test_histogram_counts_ignore_dead_and_out_of_range():
    bins = torch.tensor([[-1, 0, 3, 3, 399, 400, 7]], dtype=torch.int32)
    counts = histogram_counts(bins, 20)
    assert counts.shape == (400,) and counts.dtype == torch.int32
    assert counts[0] == 1 and counts[3] == 2 and counts[399] == 1 and int(counts.sum()) == 5


def test_pack_edges_bit_layout():
    planar = torch.tensor([[[True, False]]])
    edges = {k: torch.tensor([[[i % 2 == 0, True]]]) for i, k in enumerate(growing.EDGE_NAMES)}
    packed = growing.pack_edges(edges, planar)
    assert packed.dtype == torch.uint8
    assert packed.tolist() == [[[1 | 4 | 16, 1 | 2 | 4 | 8]]]


def _stats_pair(fields):
    """One frame's CellStats fields -> (the reference's CellStats, the
    port's batched CellStats)."""
    from deplex_tpu.ops.cellstats import CellStats as JaxCellStats

    jstats = JaxCellStats(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jstats, interop.cell_stats_from_numpy(fields, add_batch_axis=True)


def _serpentine_fields(jcfg):
    """Reference CellStats of a flat wall whose planar cells form one winding
    corridor (zero-depth strips with a gap at alternating ends)."""
    from deplex_tpu_torch.tools.kernel_bench import serpentine_depth

    h, w, P = 120, 160, jcfg.patch_size
    z = serpentine_depth(h, w, P).astype(np.float32)
    K = np.array([[520.9, 0, 80.0], [0, 521.0, 60.0], [0, 0, 1]], np.float32)
    u = (np.arange(w, dtype=np.float32)[None, :] - K[0, 2]) / K[0, 0]
    v = (np.arange(h, dtype=np.float32)[:, None] - K[1, 2]) / K[1, 1]
    pts = np.stack([u * z, v * z, z], -1).reshape(-1, 3)
    stats = jax.jit(lambda p: jax_compute_cell_stats(p, h, w, jcfg))(jnp.asarray(pts))
    return interop.fields_of(stats)


def _tie_fields(seed=3, gh=9, gw=14):
    """Synthetic CellStats with MSE ties inside bins: three plane
    orientations in vertical stripes, planar cells at random, MSE from
    three values."""
    rng = np.random.default_rng(seed)
    dirs = np.array([[0.0, 0.0, 1.0], [0.0, 0.6, 0.8], [0.6, 0.0, 0.8]], np.float32)
    pick = np.minimum(np.arange(gw) * 3 // gw, 2)[None, :].repeat(gh, 0)
    normal = dirs[pick]
    d = np.full((gh, gw), 1000.0, np.float32)
    # Each cell's mean on its plane, apart from its neighbours', so that the
    # per-round sums tell the seed cell (counted twice) from its tied peers.
    rows, cols = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    t = np.stack([cols * 50.0, rows * 50.0, np.zeros((gh, gw))], -1)
    t -= (t * normal).sum(-1, keepdims=True) * normal
    mean = (-d[..., None] * normal + t).astype(np.float32)
    planar = rng.random((gh, gw)) < 0.85
    mse = np.where(planar, rng.integers(0, 3, (gh, gw)) * 0.5,
                   np.finfo(np.float32).max).astype(np.float32)
    scatter = np.broadcast_to(np.eye(3, dtype=np.float32), (gh, gw, 3, 3)).copy()
    return {"planar": planar, "normal": normal, "mean": mean, "d": d, "mse": mse,
            "tol": np.full((gh, gw), 400.0, np.float32), "nr_pts": np.float32(100.0),
            "coord_sum": (mean * 100.0).astype(np.float32), "scatter": scatter}


def _inf_fields(seed=4):
    """_tie_fields with non-finite MSE: the left two stripes draw from +inf,
    NaN, -0.0, +0.0 and 0.5 (ties of -0.0 and +0.0), the right stripe is
    all +inf, so its bin seeds at cell 0 (the argmin over a row of +inf)."""
    fields = _tie_fields(seed)
    rng = np.random.default_rng(seed + 100)
    gh, gw = fields["mse"].shape
    palette = np.array([np.inf, np.nan, -0.0, 0.0, 0.5], np.float32)
    mse = palette[rng.integers(0, len(palette), (gh, gw))]
    mse[:, np.minimum(np.arange(gw) * 3 // gw, 2) == 2] = np.inf
    fields["mse"] = np.where(fields["planar"], mse, np.float32(np.inf)).astype(np.float32)
    return fields


@pytest.mark.parametrize("name", ["serpentine", "mse_ties", "mse_inf"])
def test_rounds_loop_matches_jax_on_adversarial_grids(name):
    """The growing kernel's twin against the reference's grow_rounds (jitted,
    as its own tests run it) on the card's adversarial K2 cases: one winding
    corridor (the longest fills), MSE ties inside bins (the seed's
    first-cell rule, which the per-round sums see: the seed counts twice),
    and +inf, NaN, -0.0 and +0.0 MSE (NaN seeds first, -0.0 ties +0.0, a
    bin of +inf seeds at cell 0)."""
    jcfg = JaxConfig()
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    fields = {"serpentine": lambda: _serpentine_fields(jcfg), "mse_ties": _tie_fields,
              "mse_inf": _inf_fields}[name]()
    jstats, stats = _stats_pair(fields)
    ref = jax.jit(lambda s: jax_grow_rounds(s, jcfg))(jstats)

    bins = normal_bins(stats.normal, stats.planar, cfg.histogram_bins_per_coord)
    round_map, seeds, nr = growing.grow_rounds_loop(
        bins, stats.mse, growing.admissibility_edges(stats, cfg), stats.planar, cfg)
    np.testing.assert_array_equal(nr[0].numpy(), np.asarray(ref.nr_rounds))
    np.testing.assert_array_equal(round_map[0].numpy(), np.asarray(ref.round_map))
    sums = growing.region_sums(round_map, seeds, stats, cfg.max_region_growing_rounds)
    _assert_sums_close(sums[0].numpy(), np.asarray(ref.sums))
    planar = fields["planar"]
    if name == "serpentine":
        # One corridor: a single round takes every planar cell.
        assert int(nr[0]) == 1 and planar.sum() > 50
        assert (round_map[0].numpy()[planar] == 0).all()
    elif name == "mse_ties":
        assert int(nr[0]) >= 3 and len(np.unique(fields["mse"][planar])) == 3
    else:
        m = fields["mse"][planar]
        assert int(nr[0]) >= 3 and np.isposinf(m).any() and np.isnan(m).any()
        assert (np.signbit(m) & (m == 0)).any() and (~np.signbit(m) & (m == 0)).any()
        # Some round seeded at a NaN cell, and some at cell 0 by the fallback.
        sd = seeds[0, :int(nr[0])].numpy()
        assert np.isnan(fields["mse"].reshape(-1)[sd]).any() and (sd == 0).any()


_WORD = (1 << 64) - 1


def _brev64(x: int) -> int:
    return int(f"{x:064b}"[::-1], 2)


def _run_fill(m: int, s: int) -> int:
    return ((((m + s) & _WORD) ^ m) & m) | s


def _rows_band_fill(seed, allowed, edges):
    """A model of the growing kernel's fill one row a lane over ceil(gh/32)
    warps (csrc/growing.cu:rows_loop), with Python ints for its 64-bit
    words: rows by the carry trick across a row's words (rightwards, and
    leftwards bit-reversed) from the same A; a pass whose rows grew
    nowhere, after the first, ends the fill; columns by each warp's 5-step
    inclusive scan of its lanes' transfers (a, m), down and up, then each
    warp's fold of the totals of the warps above and below it. Returns the
    region (gh, gw) bool and the passes."""
    gh, gw = allowed.shape
    W, nw = -(-gw // 64), -(-gh // 32)
    lanes = 32 * nw

    def words(plane):
        out = [[0] * W for _ in range(lanes)]
        for r, c in zip(*np.nonzero(plane & allowed)):
            out[int(r)][int(c) >> 6] |= 1 << (int(c) & 63)
        return out

    fl, fu, fd = words(edges["from_left"]), words(edges["from_up"]), words(edges["from_down"])
    frr = [[_brev64(w) for w in row] for row in words(edges["from_right"])]
    A = [[0] * W for _ in range(lanes)]
    r, c = seed
    A[r][c >> 6] = 1 << (c & 63)
    passes = 0
    while True:
        grew = False
        for lane in range(lanes):
            right, left, cr, cl = [0] * W, [0] * W, 0, 0
            for t in range(W):
                x = A[lane][t]
                right[t] = x | _run_fill(fl[lane][t], ((x << 1 & _WORD) | cr) & fl[lane][t])
                cr = right[t] >> 63
                k = W - 1 - t
                xr = _brev64(A[lane][k])
                left[k] = xr | _run_fill(frr[lane][k], ((xr << 1 & _WORD) | cl) & frr[lane][k])
                cl = left[k] >> 63
            nx = [right[w] | _brev64(left[w]) for w in range(W)]
            grew |= nx != A[lane]
            A[lane] = nx
        passes += 1
        if not (grew or passes == 1):
            break
        da, ua = [list(row) for row in A], [list(row) for row in A]
        dm, um = [list(row) for row in fu], [list(row) for row in fd]
        for off in (1, 2, 4, 8, 16):
            pa, pm, qa, qm = ([list(row) for row in t] for t in (da, dm, ua, um))
            for lane in range(lanes):
                lo = lane % 32
                for w in range(W):
                    if lo >= off:
                        da[lane][w] |= dm[lane][w] & pa[lane - off][w]
                        dm[lane][w] &= pm[lane - off][w]
                    if lo + off < 32:
                        ua[lane][w] |= um[lane][w] & qa[lane + off][w]
                        um[lane][w] &= qm[lane + off][w]
        for lane in range(lanes):
            warp = lane // 32
            for w in range(W):
                din = uin = 0
                for v in range(warp):
                    din = da[32 * v + 31][w] | (dm[32 * v + 31][w] & din)
                for v in range(nw - 1, warp, -1):
                    uin = ua[32 * v][w] | (um[32 * v][w] & uin)
                A[lane][w] |= da[lane][w] | (dm[lane][w] & din) | ua[lane][w] | (um[lane][w] & uin)
    region = np.array([[(A[r][c >> 6] >> (c & 63)) & 1 for c in range(gw)] for r in range(gh)],
                      bool)
    return region, passes


@pytest.mark.parametrize("gh,gw", [(20, 150), (33, 160), (65, 130), (97, 150), (120, 160),
                                   (155, 129)])
def test_the_row_band_fill_is_directed_reachability(gh, gw):
    """The kernel's one-row-a-lane fill (modelled) gives the reference's
    flood fill (and the twin's) from seeds spread over the grid, on seeded
    random directed graphs (asymmetric edges, border bits False, 20% of the
    cells not allowed), including regions that cross warps and words both
    ways. The grids have the band's 3 words a row: one warp, a warp of one
    row, last words of 32 (the kernel shuffles its halves), 2, 22 and 1
    columns, ICL's 120 x 160 and five warps."""
    rng = np.random.default_rng(gh * 1000 + gw)
    allowed = rng.random((gh, gw)) < 0.8
    edges = {k: rng.random((gh, gw)) < 0.75 for k in growing.EDGE_NAMES}
    edges["from_up"][0] = edges["from_down"][-1] = False
    edges["from_left"][:, 0] = edges["from_right"][:, -1] = False
    live = np.flatnonzero(allowed)
    crossed_warps = False
    for c in rng.choice(live, size=3, replace=False):
        seed = (int(c) // gw, int(c) % gw)
        got, passes = _rows_band_fill(seed, allowed, edges)
        mask = np.zeros((1, gh, gw), bool)
        mask[0][seed] = True
        ref = np.asarray(jax_flood_fill(jnp.asarray(mask[0]), jnp.asarray(allowed),
                                        {k: jnp.asarray(v) for k, v in edges.items()}))
        twin = growing.flood_fill(torch.from_numpy(mask), torch.from_numpy(allowed[None]),
                                  {k: torch.from_numpy(v[None]) for k, v in edges.items()})[0]
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(twin.numpy(), ref)
        rows = np.flatnonzero(got.any(1))
        crossed_warps |= rows[0] // 32 != rows[-1] // 32
        assert passes >= 2
    assert crossed_warps or gh <= 32
