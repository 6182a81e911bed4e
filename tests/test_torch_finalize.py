"""The plain twins of the cell-finalize and round-finalize kernels
(csrc/cellfinal.cu, csrc/rounds.cu) against deplex_tpu, on the CPU.

  * cell finalize (``ops.growing.finalize_cells`` through the wrapper
    ``kernels.cellfinal.cell_finalize``) against deplex_tpu's
    finalize_cell_stats, normal_bins and admissibility_edges (jitted),
    on TUM, ICL ini at P=4 and a seeded synthetic batch: fed the same
    moments (K1's twin), planar equal, means, tol and the moments passed
    through to rtol 1e-6; on the planar cells the normals as
    tests/test_torch_cellstats.py bounds them (median under 1e-5, 99th
    percentile under 1e-3, under 1% past 1e-3: with a small eigengap the
    last bit of lambda_min, XLA's float32 transcendentals against the
    port's float64-rounded ones, turns the normal), d within 1e-5 of |mean|
    where the normals agree within 1e-5, MSE within 1e-4 of trace / n (the
    Cardano eigenvalues' float32 noise scales with the largest); bins and
    packed edges
    equal to deplex_tpu's normal_bins and admissibility_edges of the
    twin's own statistics (on its own normals deplex_tpu bins one TUM cell
    of 3,072 apart: a normal at a bin edge whose last bit differs, XLA's
    float32 atan2, cos and sin against the port's float64-rounded ones);
  * ``region_sums`` (the fixed tree order) against deplex_tpu's one-hot
    products: rtol 1e-4 / atol 1.0 on counts and coordinate sums, 1e-4 of
    the trace on the scatters (tests/test_torch_growing.py's bounds: the
    products reduce in another order);
  * ``region_sums`` against a numpy model of the kernel's order (links to
    the next member of each round, sibling merges level by level, empty
    subtrees skipped), bit for bit, on seeded round maps with mixed round
    sizes and seeds;
  * the kernel's cluster split (csrc/rounds.cu: per-span warp levels over
    32 cells, linked block levels over the span's heads, then the top
    levels over the C spans) in numpy, against ``region_sums`` bit for bit
    at C = 1, 2, 4 and 8 on seeded painted round maps;
  * the wrappers' host plans: ``kernels.rounds.cluster_size`` a power of two
    up to 8 whose spans are aligned and cover the frame;
    ``kernels.cellfinal.tile_plan`` tiles that cover every cell once with
    each cell's in-grid neighbours in the tile or its ring (1.04x the fits
    at TUM B=64);
  * round finalize (``ops.growing.finalize_grown``) against deplex_tpu's
    region_sums + finalize_rounds: labels_map and nr_planes equal, the
    slot tables to rtol 1e-4 (normals 1e-4 absolute);
  * round finalize at 0 rounds and at 2048 (past the kernel's shared
    memory): empty outputs, and the 256-round results with zero rows past
    them;
  * the wrappers: the twin for CPU tensors, a ValueError for other
    devices, no launch counted;
  * the whole main path on TUM through the wrappers: 34 planes, the JAX
    package's labels.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu import Config as JaxConfig
from deplex_tpu.ops.cellstats import CellMoments as JaxCellMoments
from deplex_tpu.ops.cellstats import finalize_cell_stats as jax_finalize_cell_stats
from deplex_tpu.ops.growing import RoundData as JaxRoundData
from deplex_tpu.ops.growing import admissibility_edges as jax_edges
from deplex_tpu.ops.growing import finalize_rounds as jax_finalize_rounds
from deplex_tpu.ops.growing import region_sums as jax_region_sums
from deplex_tpu.ops.histogram import normal_bins as jax_normal_bins
from deplex_tpu.parallel.batch import extract_depth_batch_jit as jax_extract_depth_batch
from deplex_tpu_torch import Config, interop, kernels
from deplex_tpu_torch.kernels import cellfinal as k_final
from deplex_tpu_torch.kernels import cellstats as k_cells
from deplex_tpu_torch.kernels import growing as k_grow
from deplex_tpu_torch.kernels import rounds as k_rounds
from deplex_tpu_torch.ops import growing
from deplex_tpu_torch.ops.cellstats import cell_moments_reference, patch_size
from deplex_tpu_torch.parallel.batch import extract_depth_batch
from deplex_tpu_torch.pipeline import compute_cells, intrinsics_tensor
from deplex_tpu_torch.tools.kernel_bench import random_cell_stats, random_rounds_case

from .conftest import DATA


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _staircases(rng, n, h=120, w=160):
    """Seeded synthetic depth: random boxes at random depths on a wall."""
    frames = []
    for _ in range(n):
        z = np.full((h, w), 4000, np.uint16)
        for _ in range(6):
            r0, c0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
            z[r0:r0 + 40, c0:c0 + 40] = int(rng.uniform(2000, 6000))
        frames.append(z)
    return np.stack(frames)


def _case(name):
    """(uint16 depth (B, H, W), K, JAX config) of a named case."""
    from deplex_tpu.utils import DepthImage, read_intrinsics

    if name == "synthetic":
        K = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]], np.float32)
        return _staircases(np.random.default_rng(0), 3), K, JaxConfig()
    png, kfile, ini = {"tum": ("tum/1341848230.910894.png", "TUM_fr3_long_val.K", None),
                       "icl_ini": ("icl_nuim/0.png", "ICL_living_room.K",
                                   "ICL_living_room.ini")}[name]
    img = DepthImage(str(DATA / png))
    jcfg = JaxConfig.from_ini(str(DATA / "configs" / ini)) if ini else JaxConfig()
    return img.data[None], read_intrinsics(str(DATA / "configs" / kfile)), jcfg


def _moments(depth, K, cfg):
    return cell_moments_reference(torch.from_numpy(depth.astype(np.int32)),
                                  intrinsics_tensor(K, "cpu"), cfg)


def _jax_finalize(m, P, jcfg):
    """deplex_tpu's finalize_cell_stats of (B, ...) moments."""
    fn = jax.jit(jax.vmap(lambda q: jax_finalize_cell_stats(q, P, jcfg)))
    return fn(JaxCellMoments(*(jnp.asarray(f.numpy()) for f in m)))


def _jax_bins_edges(stats, jcfg):
    """deplex_tpu's normal_bins and packed admissibility_edges of the port's
    (B, ...) CellStats."""
    from deplex_tpu.ops.cellstats import CellStats as JaxCellStats

    @jax.jit
    def run(s):
        bins = jax_normal_bins(s.normal, s.planar, jcfg.histogram_bins_per_coord)
        return bins, jax.vmap(lambda q: jax_edges(q, jcfg))(s)
    B = stats.planar.shape[0]
    js = JaxCellStats(*(jnp.asarray(np.broadcast_to(f.numpy(), (B,)) if f.dim() == 0
                                    else f.numpy()) for f in stats))
    bins, edges = run(js)
    packed = np.asarray(stats.planar).astype(np.uint8) << 4
    for k, name in enumerate(growing.EDGE_NAMES):
        packed |= np.asarray(edges[name]).astype(np.uint8) << k
    return np.asarray(bins), packed


@pytest.mark.parametrize("name", ["tum", "icl_ini", "synthetic"])
def test_cell_finalize_twin_matches_jax(name):
    depth, K, jcfg = _case(name)
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    P = patch_size(depth.shape[1], depth.shape[2], cfg)
    m = _moments(depth, K, cfg)
    planes = k_cells.cell_moment_planes(torch.from_numpy(depth.astype(np.int32)),
                                        intrinsics_tensor(K, "cpu"), cfg)
    cells = k_final.cell_finalize(planes, P, cfg)
    ref = _jax_finalize(m, P, jcfg)
    got = cells.stats

    planar = np.asarray(ref.planar)
    assert planar.sum() > 0
    np.testing.assert_array_equal(got.planar.numpy(), planar)
    ref_bins, ref_packed = _jax_bins_edges(got, jcfg)
    np.testing.assert_array_equal(cells.bins.numpy(), ref_bins)
    np.testing.assert_array_equal(cells.edges.numpy(), ref_packed)
    assert cells.bins.dtype == torch.int32 and cells.edges.dtype == torch.uint8
    for f in ("mean", "tol", "coord_sum", "scatter"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    ndiff = np.abs(got.normal.numpy() - np.asarray(ref.normal)).max(-1)
    assert float(np.median(ndiff[planar])) < 1e-5
    assert float(np.quantile(ndiff[planar], 0.99)) < 1e-3
    assert float((ndiff[planar] > 1e-3).mean()) < 0.01
    agree = planar & (ndiff <= 1e-5)
    d_err = np.abs(got.d.numpy() - np.asarray(ref.d))
    assert (d_err <= 1e-5 * np.linalg.norm(got.mean.numpy(), axis=-1))[agree].all()
    mse, ref_mse = got.mse.numpy(), np.asarray(ref.mse)
    np.testing.assert_array_equal(mse[~planar], ref_mse[~planar])          # F32_MAX
    trace = np.trace(got.scatter.numpy(), axis1=-2, axis2=-1)
    assert (np.abs(mse - ref_mse) <= 1e-4 * trace / (P * P))[planar].all()
    assert float(got.nr_pts) == float(np.asarray(ref.nr_pts).ravel()[0]) == P * P


def _assert_sums_close(got, ref):
    """RoundData.sums rows: [n, sx, sy, sz, 6 scatter entries, size, 0...]."""
    cols = [0, 1, 2, 3, 10]
    np.testing.assert_allclose(got[..., cols], ref[..., cols], rtol=1e-4, atol=1.0)
    trace = ref[..., 4] + ref[..., 7] + ref[..., 9]
    err = np.abs(got[..., 4:10] - ref[..., 4:10])
    assert (err <= 1e-4 * np.abs(trace)[..., None] + 1.0).all(), float(err.max())


def _grown(name):
    """The port's CellGrid and K2-twin outputs of a case, and its configs."""
    depth, K, jcfg = _case(name)
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    cells = compute_cells(torch.from_numpy(depth.astype(np.int32)), intrinsics_tensor(K, "cpu"),
                          cfg)
    return cells, k_grow.grow_rounds(cells, cfg), cfg, jcfg


def _jax_stats(stats):
    """The port's (B, ...) CellStats as deplex_tpu's, one frame at a time."""
    from deplex_tpu.ops.cellstats import CellStats as JaxCellStats

    return [JaxCellStats(*(jnp.asarray(f.numpy()[b] if f.dim() else f.numpy())
                           for f in stats)) for b in range(stats.planar.shape[0])]


@pytest.mark.parametrize("name", ["tum", "icl_ini", "synthetic"])
def test_region_sums_and_round_finalize_twins_match_jax(name):
    cells, (round_map, seeds, nr_rounds), cfg, jcfg = _grown(name)
    assert int(nr_rounds.max()) > 3
    R = cfg.max_region_growing_rounds
    rounds, labels_map, seg = k_rounds.round_finalize(round_map, seeds, nr_rounds,
                                                      cells.stats, cfg)
    # The wrapper on the CPU is the twin.
    twin = growing.finalize_grown(round_map, seeds, nr_rounds, cells.stats, cfg)
    assert torch.equal(rounds.sums, twin[0].sums) and torch.equal(labels_map, twin[1])

    @jax.jit
    def ref_fn(rm, sd, nr, s):
        sums = jax_region_sums(rm, sd, s, R)
        return sums, jax_finalize_rounds(JaxRoundData(round_map=rm, sums=sums, nr_rounds=nr),
                                         jcfg)
    for b, jstats in enumerate(_jax_stats(cells.stats)):
        ref_sums, (ref_lm, ref_seg) = ref_fn(jnp.asarray(round_map[b].numpy()),
                                             jnp.asarray(seeds[b].numpy()),
                                             jnp.asarray(nr_rounds[b].numpy()), jstats)
        _assert_sums_close(rounds.sums[b].numpy(), np.asarray(ref_sums))
        np.testing.assert_array_equal(labels_map[b].numpy(), np.asarray(ref_lm))
        assert int(seg.nr_planes[b]) == int(ref_seg.nr_planes)
        for f in ("n", "coord_sum", "mean", "d", "score"):
            np.testing.assert_allclose(getattr(seg, f)[b].numpy(),
                                       np.asarray(getattr(ref_seg, f)),
                                       rtol=1e-4, atol=1e-3, err_msg=f)
        np.testing.assert_allclose(seg.normal[b].numpy(), np.asarray(ref_seg.normal),
                                   rtol=0, atol=1e-4)
        tr = np.trace(np.asarray(ref_seg.scatter), axis1=-2, axis2=-1)
        assert (np.abs(seg.scatter[b].numpy() - np.asarray(ref_seg.scatter))
                <= 1e-4 * tr[..., None, None] + 1e-2).all()


def _kernel_order_sums(round_map, seeds, coord_sum, mean, scatter, nr_pts, r_max):
    """A numpy model of csrc/rounds.cu's region sums, float32 throughout:
    links from each member to the next member of its round in raster
    order; at level l a head whose level-l node is a left child adds the
    next head of its round when that head's node is its right sibling
    (empty subtrees are skipped); the round's first member ends with the
    root. Returns (B, r_max, 16) rows."""
    f32 = np.float32
    B, N = round_map.shape
    levels = max(0, (N - 1).bit_length())
    out = np.zeros((B, r_max, 16), f32)
    for b in range(B):
        rm = round_map[b]
        member = (rm >= 0) & (rm < r_max)
        nxt0 = np.full(N, -1, np.int64)
        first = np.full(r_max, -1, np.int64)
        for p in range(N - 1, -1, -1):
            if member[p]:
                nxt0[p] = first[rm[p]]
                first[rm[p]] = p
        cnt = np.bincount(rm[member], minlength=r_max)
        seed = seeds[b]
        pos = np.arange(N)
        w = np.where(seed[np.clip(rm, 0, r_max - 1)] == pos, f32(2), f32(1))

        def tree(leaves):
            v = np.where(member[:, None], (w[:, None] * leaves + f32(0)).astype(f32), f32(0))
            head, nxt = member.copy(), nxt0.copy()
            for lv in range(levels):
                q = nxt
                left = head & (((pos >> lv) & 1) == 0) & (q >= 0)
                left &= (np.where(q >= 0, q, 0) >> lv) == (pos >> lv) + 1
                p_idx, q_idx = pos[left], q[left]
                v[p_idx] = v[p_idx] + v[q_idx]
                new_nxt = nxt.copy()
                new_nxt[p_idx] = nxt[q_idx]
                head[q_idx] = False
                nxt = new_nxt
            return np.stack([v[first[r]] if first[r] >= 0 else np.zeros(v.shape[1], f32)
                             for r in range(r_max)])

        sums = tree(coord_sum[b])
        seedm = np.array([0 <= seed[r] < N and rm[seed[r]] == r for r in range(r_max)])
        n_tot = ((cnt + seedm).astype(f32) * nr_pts).astype(f32)
        mu = (sums / np.maximum(n_tot, f32(1))[:, None]).astype(f32)
        d = mean[b] - mu[np.clip(rm, 0, r_max - 1)]
        sc = scatter[b].reshape(N, 9)
        feat = np.stack([sc[:, k] + nr_pts * d[:, i] * d[:, j] for k, i, j in
                         ((0, 0, 0), (1, 0, 1), (2, 0, 2), (4, 1, 1), (5, 1, 2), (8, 2, 2))],
                        -1).astype(f32)
        out[b, :, 0] = n_tot
        out[b, :, 1:4] = sums
        out[b, :, 4:10] = tree(feat)
        out[b, :, 10] = cnt
    return out


@pytest.mark.parametrize("gh,gw", [(7, 13), (48, 64), (30, 50)])
def test_region_sums_twin_is_the_kernel_order_bit_for_bit(gh, gw, monkeypatch):
    """Seeded round maps from K2's twin on random directed graphs (rounds
    of one cell to hundreds), seeded cell statistics; the twin's dense
    halving and the kernel's skipping model agree in every bit."""
    rng = np.random.default_rng(gh * 1000 + gw)
    cfg = Config()
    bins, mse, packed = (torch.from_numpy(a) for a in random_rounds_case(rng, 3, gh, gw))
    edges, planar = growing.unpack_edges(packed)
    round_map, seeds, nr = growing.grow_rounds_loop(bins, mse, edges, planar, cfg)
    sizes = np.bincount(round_map.numpy().ravel() + 1)[1:]
    assert (sizes == 1).any() and sizes.max() >= 10          # mixed round sizes
    stats = random_cell_stats(rng, 3, gh, gw, "cpu")
    got = growing.region_sums(round_map, seeds, stats, cfg.max_region_growing_rounds)
    B, N = 3, gh * gw
    ref = _kernel_order_sums(round_map.numpy().reshape(B, N), seeds.numpy(),
                             stats.coord_sum.numpy().reshape(B, N, 3),
                             stats.mean.numpy().reshape(B, N, 3),
                             stats.scatter.numpy().reshape(B, N, 3, 3),
                             np.float32(stats.nr_pts), cfg.max_region_growing_rounds)
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    # The grouping of rounds (memory bound) does not change the bits.
    monkeypatch.setattr(growing, "REGION_SUMS_GROUP_ELEMENTS", B * N * 6 * 5)
    small = growing.region_sums(round_map, seeds, stats, cfg.max_region_growing_rounds)
    assert torch.equal(small.view(torch.int32), got.view(torch.int32))


def _spans(N, C):
    """Each block's span of cells [start, stop) in rank order: aligned
    blocks of ``span_cells(N, C)`` (a span past the frame is empty)."""
    S = k_rounds.span_cells(N, C)
    return [(min(N, j * S), min(N, (j + 1) * S)) for j in range(C)]


def _cluster_order_tree(rm, terms, r_max, C):
    """A numpy model of csrc/rounds.cu's sum of one frame's member terms
    (N, K) float32 by round (rm (N,), -1 or >= r_max: no round) on C
    blocks: per span of S cells, warp levels 0-4 (each lane adds a lane of
    its round in the sibling half), the heads (a round's first lane in a
    warp) linked to the next head of their round and merged level by level
    (5 to log2 S - 1), then the pairwise tree over the C spans' sums,
    empty ones skipped. Returns (r_max, K)."""
    N, K = terms.shape
    S = k_rounds.span_cells(N, C)
    lanes = np.arange(32)
    spans = []
    for lo, hi in _spans(N, C):
        roots = {}
        n = hi - lo
        if n > 0:
            nch = -(-n // 32)
            r = np.full(nch * 32, -1)
            r[:n] = np.where((rm[lo:hi] >= 0) & (rm[lo:hi] < r_max), rm[lo:hi], -1)
            v = np.zeros((nch * 32, K), np.float32)
            v[:n] = terms[lo:hi]
            r, v = r.reshape(nch, 32), v.reshape(nch, 32, K)
            same = r[:, :, None] == r[:, None, :]
            for lv in range(5):
                sib = ((lanes[:, None] >> lv) ^ 1) == (lanes[None, :] >> lv)
                cand = same & sib[None]
                partner = np.take_along_axis(v, cand.argmax(-1)[..., None], axis=1)
                v = np.where(cand.any(-1)[..., None], v + partner, v)
            head = (r >= 0) & ~(same & (lanes[None, :] < lanes[:, None])[None]).any(-1)
            pos = np.flatnonzero(head.ravel())           # span-local, raster order
            hr, hv = r.ravel()[pos], v.reshape(-1, K)[pos].copy()
            H = len(pos)
            nxt = np.full(H, -1)
            last = {}
            for i in range(H - 1, -1, -1):
                nxt[i] = last.get(hr[i], -1)
                last[hr[i]] = i
            live = np.ones(H, bool)
            for lv in range(5, S.bit_length() - 1):
                for i in range(H):
                    q = nxt[i]
                    if not live[i] or (pos[i] >> lv) & 1 or q < 0 \
                            or (pos[q] >> lv) != (pos[i] >> lv) + 1:
                        continue
                    hv[i] = hv[i] + hv[q]
                    nxt[i] = nxt[q]
                    live[q] = False
            roots = {int(hr[i]): hv[i] for i in last.values()}
        spans.append(roots)
    out = np.zeros((r_max, K), np.float32)
    for rr in range(r_max):
        x = [sp.get(rr) for sp in spans]
        step = 1
        while step < C:
            for j in range(0, C - step, 2 * step):
                if x[j + step] is not None:
                    x[j] = x[j + step] if x[j] is None else x[j] + x[j + step]
            step *= 2
        if x[0] is not None:
            out[rr] = x[0]
    return out


def _cluster_order_sums(round_map, seeds, coord_sum, mean, scatter, nr_pts, r_max, C):
    """``_kernel_order_sums``' rows with the cluster split's order."""
    f32 = np.float32
    B, N = round_map.shape
    out = np.zeros((B, r_max, 16), f32)
    for b in range(B):
        rm = round_map[b]
        member = (rm >= 0) & (rm < r_max)
        rr = np.clip(rm, 0, r_max - 1)
        w = np.where(seeds[b][rr] == np.arange(N), f32(2), f32(1))[:, None]
        sums = _cluster_order_tree(rm, np.where(member[:, None], w * coord_sum[b] + f32(0),
                                                f32(0)), r_max, C)
        cnt = np.bincount(rm[member], minlength=r_max)
        seedm = np.array([0 <= seeds[b][r] < N and rm[seeds[b][r]] == r for r in range(r_max)])
        n_tot = ((cnt + seedm).astype(f32) * nr_pts).astype(f32)
        mu = (sums / np.maximum(n_tot, f32(1))[:, None]).astype(f32)
        d = mean[b] - mu[rr]
        sc = scatter[b].reshape(N, 9)
        feat = np.stack([sc[:, k] + nr_pts * d[:, i] * d[:, j] for k, i, j in
                         ((0, 0, 0), (1, 0, 1), (2, 0, 2), (4, 1, 1), (5, 1, 2), (8, 2, 2))],
                        -1).astype(f32)
        out[b, :, 0] = n_tot
        out[b, :, 1:4] = sums
        out[b, :, 4:10] = _cluster_order_tree(rm, np.where(member[:, None], w * feat + f32(0),
                                                           f32(0)), r_max, C)
        out[b, :, 10] = cnt
    return out


def _painted_rounds(rng, B, gh, gw, r_max):
    """Seeded round maps: rectangles of rounds (ids up to r_max + 3, so
    some are not rounds), one-cell rounds and holes; each round's seed a
    member, a non-member cell, or none (N)."""
    N = gh * gw
    rm = np.full((B, gh, gw), -1, np.int32)
    seeds = np.full((B, r_max), N, np.int32)
    for b in range(B):
        for _ in range(3 * r_max // 2):
            r0, c0 = rng.integers(0, gh), rng.integers(0, gw)
            rm[b, r0:r0 + rng.integers(1, gh // 2 + 2),
               c0:c0 + rng.integers(1, gw // 2 + 2)] = rng.integers(0, r_max + 4)
        flat = rm[b].reshape(-1)
        flat[rng.integers(0, N, N // 20)] = rng.integers(0, r_max, N // 20)
        flat[rng.integers(0, N, N // 10)] = -1
        for r in range(r_max):
            cells = np.flatnonzero(flat == r)
            kind = rng.integers(0, 4)
            if len(cells) and kind < 2:
                seeds[b, r] = rng.choice(cells)
            elif kind == 2:
                seeds[b, r] = rng.integers(0, N)
    return rm, seeds


@functools.lru_cache(maxsize=None)
def _painted_case(gh, gw):
    """A painted case of 2 frames at 64 rounds and the twin's sums of it."""
    rng = np.random.default_rng(gh * 1000 + gw + 1)
    r_max = 64
    rm, seeds = _painted_rounds(rng, 2, gh, gw, r_max)
    stats = random_cell_stats(rng, 2, gh, gw, "cpu")
    got = growing.region_sums(torch.from_numpy(rm), torch.from_numpy(seeds), stats, r_max)
    return rm, seeds, stats, r_max, got.numpy()


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("gh,gw", [(7, 13), (48, 64), (30, 50), (120, 160)])
def test_cluster_split_is_the_twin_order_bit_for_bit(gh, gw, C):
    """Per-span trees then the top levels over C spans give the twin's bits
    (``region_sums``' dense halving), whatever C cuts the frame into."""
    rm, seeds, stats, r_max, got = _painted_case(gh, gw)
    B, N = rm.shape[0], gh * gw
    assert len(np.unique(rm)) > r_max // 2 and (rm >= r_max).any() and (rm < 0).any()
    ref = _cluster_order_sums(rm.reshape(B, N), seeds, stats.coord_sum.numpy().reshape(B, N, 3),
                              stats.mean.numpy().reshape(B, N, 3),
                              stats.scatter.numpy().reshape(B, N, 3, 3),
                              np.float32(stats.nr_pts), r_max, C)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


# Clusters of 1, 2, 4 and 8 blocks an H100 runs at once (round finalize at
# TUM's 3,072 cells and 256 rounds, one block an SM), and a small card's.
ACTIVE = ({1: 132, 2: 66, 4: 32, 8: 16}, {1: 16, 2: 8, 4: 4, 8: 2})


@pytest.mark.parametrize("B", [1, 2, 8, 64, 128])
def test_cluster_size_is_a_power_of_two_with_aligned_spans(B):
    for N in (91, 650, 1500, 3072, 5000, 19200, 75000):
        for active in ACTIVE:
            C = k_rounds.cluster_size(B, N, active)
            assert C in (1, 2, 4, 8)
            # One wave wherever a size whose span fits in shared memory gives one.
            shared = [c for c in (1, 2, 4, 8)
                      if k_rounds.span_cells(N, c) <= k_rounds.SPAN_CELLS_SHARED]
            assert B <= active[C] or all(B > active[c] for c in shared)
            S = k_rounds.span_cells(N, C)
            assert S >= 32 and S & (S - 1) == 0 and S * C >= N
            spans = _spans(N, C)
            assert len(spans) == C
            for j, (lo, hi) in enumerate(spans):
                assert lo == min(N, j * S) and hi == min(N, lo + S) and (lo == N or lo % S == 0)
            assert np.array_equal(np.concatenate([np.arange(lo, hi) for lo, hi in spans]),
                                  np.arange(N))
    # TUM (48 x 64 cells) on the H100: 8 blocks a frame at B=1; at B=64, 2
    # (64 clusters of 4 would not run at once); ICL (120 x 160): 8, whose
    # 4,096-cell spans fit in shared memory.
    tum = {1: 132, 2: 66, 4: 62, 8: 30}
    assert k_rounds.cluster_size(1, 3072, tum) == 8
    assert k_rounds.cluster_size(64, 3072, tum) == 2
    assert k_rounds.cluster_size(32, 3072, tum) == 4
    assert k_rounds.cluster_size(64, 19200, {1: 132, 2: 66, 4: 33, 8: 16}) == 8
    assert k_rounds.cluster_size(1, 91, tum) == 4


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("gh,gw", [(7, 13), (48, 64), (120, 160), (300, 250), (90, 160),
                                   (3, 4)])
def test_tile_plan_covers_each_cell_once_with_its_neighbours(gh, gw, B):
    rows, cols = k_final.tile_plan(B, gh, gw, 132)
    assert 1 <= rows <= gh and 1 <= cols <= min(gw, k_final.TILE_MAX_COLS)
    seen = np.zeros((gh, gw), np.int64)
    for cells, ring in k_final.tiles(gh, gw, rows, cols):
        tile = set(cells) | set(ring)
        assert len(tile) == len(cells) + len(ring)
        assert all(0 <= r < gh and 0 <= c < gw for r, c in ring)
        for r, c in cells:
            seen[r, c] += 1
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                assert not (0 <= rr < gh and 0 <= cc < gw) or (rr, cc) in tile
    assert (seen == 1).all()


def test_tile_plan_recomputes_under_a_tenth_at_tum_b64():
    """Two 24-row bands of TUM's 64-cell rows at B=64: 1.04x the fits."""
    rows, cols = k_final.tile_plan(64, 48, 64, 132)
    fits = sum(len(c) + len(r) for c, r in k_final.tiles(48, 64, rows, cols))
    assert (rows, cols) == (24, 64) and fits / (48 * 64) <= 1.1


def test_tree_sum_pads_to_a_power_of_two():
    x = torch.tensor([[1.0], [2.0], [3.0], [2.0 ** 24]], dtype=torch.float32)
    # (1 + 2) + (3 + 2^24) in float32: 3 + 2^24 rounds to 2^24 + 4, then 3 +
    # (2^24 + 4) to 2^24 + 8; left to right would give 2^24 + 6.
    f32 = np.float32
    assert float(growing.tree_sum(x)[0]) == float((f32(1) + f32(2)) + (f32(3) + f32(2 ** 24)))
    assert float(growing.tree_sum(x)[0]) == 2.0 ** 24 + 8
    assert float(growing.tree_sum(x[:3])[0]) == 6.0
    assert float(growing.tree_sum(x[:1])[0]) == 1.0


@pytest.mark.parametrize("r_max", [0, 2048])
def test_round_finalize_takes_any_number_of_rounds(r_max):
    """Round finalize at 0 rounds (no round ran: every label 0, no plane,
    empty tables) and at 2048 (past what the kernel keeps in shared
    memory): the rounds that ran give what they give at 256 rounds, the
    rows past them are zero."""
    rng = np.random.default_rng(7)
    arrays = [torch.from_numpy(a) for a in random_rounds_case(rng, 3, 7, 13)]
    stats = random_cell_stats(rng, 3, 7, 13, "cpu")
    cfg = Config()
    edges, planar = growing.unpack_edges(arrays[2])
    grown = growing.grow_rounds_loop(arrays[0], arrays[1], edges, planar, cfg)
    ref = k_rounds.round_finalize(*grown, stats, cfg)
    many = cfg.replace(max_region_growing_rounds=r_max)
    if r_max:
        grown = growing.grow_rounds_loop(arrays[0], arrays[1], edges, planar, many)
        assert torch.equal(grown[2], ref[0].nr_rounds)
    else:
        grown = (torch.full_like(grown[0], -1), torch.zeros((3, 0), dtype=torch.int32),
                 torch.zeros_like(grown[2]))
    rounds, labels_map, segments = k_rounds.round_finalize(*grown, stats, many)
    assert rounds.sums.shape == (3, r_max, 16)
    if not r_max:
        assert not labels_map.any() and not segments.nr_planes.any()
        assert all(not t.any() for t in segments)
        return
    R = cfg.max_region_growing_rounds
    assert torch.equal(rounds.sums[:, :R], ref[0].sums) and not rounds.sums[:, R:].any()
    assert torch.equal(labels_map, ref[1]) and int(segments.nr_planes.sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(segments, ref[2]))


def test_wrappers_run_the_twins_on_the_cpu_and_raise_elsewhere():
    depth, K, jcfg = _case("synthetic")
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    kernels.reset_launch_counts()
    src = torch.from_numpy(depth.astype(np.int32))
    planes = k_cells.cell_moment_planes(src, intrinsics_tensor(K, "cpu"), cfg)
    assert planes.shape == (13, 3, 12, 16)
    P = cfg.patch_size
    cells = k_final.cell_finalize(planes, P, cfg)
    twin = growing.finalize_cells(_moments(depth, K, cfg), P, cfg)
    for a, b in zip((*cells.stats, cells.bins, cells.edges),
                    (*twin.stats, twin.bins, twin.edges)):
        assert torch.equal(a, b)
    grown = k_grow.grow_rounds(cells, cfg)
    out = k_rounds.round_finalize(*grown, cells.stats, cfg)
    ref = growing.finalize_grown(*grown, cells.stats, cfg)
    assert torch.equal(out[0].sums, ref[0].sums) and torch.equal(out[1], ref[1])
    assert all(torch.equal(a, b) for a, b in zip(out[2], ref[2]))
    assert all(n == 0 for n in kernels.launch_counts().values())
    assert {"cell_finalize", "round_finalize"} <= set(kernels.PLANE_KERNELS)

    meta = planes.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k_final.cell_finalize(meta, P, cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        k_rounds.round_finalize(*(t.to("meta") for t in grown),
                                type(cells.stats)(*(t.to("meta") for t in cells.stats)), cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        k_grow.grow_rounds(type(cells)(type(cells.stats)(*(t.to("meta") for t in cells.stats)),
                                       cells.bins.to("meta"), cells.edges.to("meta")), cfg)
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_main_path_through_the_wrappers_matches_jax(tum_image):
    """Stages 1-5 of a B=2 TUM batch on the CPU (K1, cell finalize, K2,
    round finalize and K3 through their wrappers): 34 planes, the JAX
    package's labels, and the grid's bins and edges are the plain
    composition's."""
    from deplex_tpu_torch.pipeline import depth_tensor

    depth, K = tum_image
    batch = np.stack([depth, depth])
    got = extract_depth_batch(depth_tensor(batch, "cpu"), K, Config()).numpy()
    ref = np.asarray(jax_extract_depth_batch(jnp.asarray(batch), jnp.asarray(K),
                                             config=JaxConfig()))
    np.testing.assert_array_equal(got, ref.astype(np.int32))
    assert int(got[0].max()) == 34
    cells = compute_cells(torch.from_numpy(depth.astype(np.int32))[None],
                          intrinsics_tensor(K, "cpu"), Config())
    plain = growing.grid_of_stats(cells.stats, Config())
    assert torch.equal(cells.bins, plain.bins) and torch.equal(cells.edges, plain.edges)
