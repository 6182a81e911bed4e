"""deplex_tpu_torch.ops.ransac (stage 6) vs deplex_tpu.ops.ransac.

The JAX package draws its 3-point samples with jax.random, whose bits the
port does not reproduce; the port takes the raw draws as ``draws=``. Fed the
JAX package's own draws (built here exactly as it builds them), the port
must give equal labels on both sampling paths: losses are integer counts and
the distances are formed in the same elementwise order, so no tolerance is
needed. On the shipped RANSAC ini the port's seeded draws must meet the
golden bounds of tests/test_refinement.py, F1 on the mean of eight streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu import Config as JaxConfig
from deplex_tpu.ops import ransac as jransac
from deplex_tpu_torch import Config, PlaneExtractor
from deplex_tpu_torch.ops import ransac
from deplex_tpu_torch.parallel.batch import BatchDepthExtractor

from .conftest import DATA, label_f1


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_draws(counts, max_planes: int, iterations: int) -> torch.Tensor:
    """The raw ranks the JAX package draws with its default key: one split
    key per plane, randint over [0, max(count, 1))."""
    keys = jax.random.split(jax.random.PRNGKey(0), max_planes)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.randint(keys[p], (iterations, 3), 0, max(int(counts[p]), 1)))
        for p in range(max_planes)]))


def chunk_scene(seed=7):
    """tests/test_refinement.py's chunking scene: 4 planes on a 5x16 cell grid
    of 8x8 cells, plane 1 made a real plane so that early exit fires."""
    rng = np.random.default_rng(seed)
    H, W, P = 40, 128, 8
    cell_lab = rng.integers(0, 4, (H // P, W // P)).astype(np.int32)
    labels = np.repeat(np.repeat(cell_lab, P, 0), P, 1).reshape(-1)
    z = rng.uniform(500, 3000, (H, W)).astype(np.float32)
    z[:16] = 1000.0
    u = (np.arange(W) - W / 2 + .5) / 200.0
    v = (np.arange(H)[:, None] - H / 2 + .5) / 200.0
    pts = np.stack([u * z, np.broadcast_to(v, (H, W)) * z, z], -1).reshape(-1, 3)
    return pts.astype(np.float32), labels, cell_lab, W, P


def scene_config(ratio, cls=Config):
    return cls(patch_size=8, max_planes=4, ransac_refinement=True, ransac_max_iterations=192,
               ransac_inliers_ratio=ratio, ransac_threshold=5.0)


# ---------------------------------------------------------------- the winner

@pytest.mark.parametrize("loss, n, ratio, winner", [
    ([10.0, 3.0, 6.0, 1.0, 4.0], 20.0, 1.0, 3),   # ratio 1: the global argmin
    ([10.0, 3.0, 6.0, 1.0], 20.0, 0.8, 1),        # stops before the global best
    ([8.0, 9.0, 2.0, 1.0], 20.0, 0.85, 2),        # the best of the prefix
], ids=["global_argmin", "early_exit", "best_of_prefix"])
def test_reference_stop_winner(loss, n, ratio, winner):
    got = ransac.reference_stop_winner(torch.tensor(loss), torch.tensor(n), torch.tensor(ratio))
    ref = jransac.reference_stop_winner(jnp.asarray(loss), jnp.float32(n), jnp.float32(ratio))
    assert int(got) == int(ref) == winner


def test_fit_3pt_plane_matches_jax_and_degenerate_is_nan():
    rng = np.random.default_rng(3)
    tri = (rng.normal(size=(64, 3, 3)) * 1000 + [0, 0, 3000]).astype(np.float32)
    tri[5, 2] = tri[5, 0]                                  # repeated points: no plane
    tri[9, 1] = tri[9, 0]
    n, d = ransac._fit_3pt_plane(*(torch.from_numpy(tri[:, i]) for i in range(3)))
    jn, jd = jransac._fit_3pt_plane(*(jnp.asarray(tri[:, i]) for i in range(3)))
    jn, jd = np.asarray(jn), np.asarray(jd)
    finite = np.isfinite(jd)
    assert not finite[5] and not finite[9]
    np.testing.assert_array_equal(torch.isfinite(d).numpy(), finite)
    # float32: the same elementwise formula, so equal up to a rounding step.
    np.testing.assert_allclose(n.numpy()[finite], jn[finite], rtol=0, atol=2e-6)
    np.testing.assert_allclose(d.numpy()[finite], jd[finite], rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(n.numpy()[finite], axis=1), 1.0, atol=1e-6)


# ------------------------------------------------ refine_labels, JAX's draws

@pytest.mark.parametrize("ratio", [0.15, 0.5, 1.0])
def test_cell_path_equals_jax_with_its_draws(ratio):
    pts, labels, cell_lab, W, P = chunk_scene()
    ref = np.asarray(jransac.refine_labels(
        jnp.asarray(pts), jnp.asarray(labels), scene_config(ratio, JaxConfig),
        cell_labels=jnp.asarray(cell_lab), image_width=W, patch_size=P, chunk_size=64))
    counts = np.bincount(cell_lab.ravel(), minlength=5)[1:] * P * P
    got = ransac.refine_labels(torch.from_numpy(pts), torch.from_numpy(labels),
                               scene_config(ratio), draws=jax_draws(counts, 4, 192),
                               cell_labels=torch.from_numpy(cell_lab), image_width=W,
                               patch_size=P, chunk_size=64)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.int32
    assert 0 < int((ref > 0).sum()) < int((labels > 0).sum())   # it did refine


@pytest.mark.parametrize("ratio", [0.15, 1.0])
def test_pixel_fallback_equals_jax_with_its_draws(ratio):
    pts, labels, _, _, _ = chunk_scene()
    labels = labels.copy()
    labels[::7] = 0                              # not whole cells: arbitrary pixel labels
    ref = np.asarray(jransac.refine_labels(jnp.asarray(pts), jnp.asarray(labels),
                                           scene_config(ratio, JaxConfig), chunk_size=64))
    counts = np.bincount(labels, minlength=5)[1:]
    got = ransac.refine_labels(torch.from_numpy(pts), torch.from_numpy(labels),
                               scene_config(ratio), draws=jax_draws(counts, 4, 192),
                               chunk_size=64)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ratio", [0.15, 0.5, 1.0])
def test_chunking_invariant(ratio):
    """The stopping rule is prefix-determined: chunk boundaries (and the
    early break) cannot change the winner, on either sampling path."""
    pts, labels, cell_lab, W, P = chunk_scene()
    args = (torch.from_numpy(pts), torch.from_numpy(labels), scene_config(ratio))
    cells = dict(cell_labels=torch.from_numpy(cell_lab), image_width=W, patch_size=P)
    for kw in (cells, {}):
        one = ransac.refine_labels(*args, chunk_size=192, **kw)
        multi = ransac.refine_labels(*args, chunk_size=64, **kw)
        odd = ransac.refine_labels(*args, chunk_size=50, **kw)     # a padded last chunk
        torch.testing.assert_close(one, multi, rtol=0, atol=0)
        torch.testing.assert_close(one, odd, rtol=0, atol=0)


def test_generator_draws_are_seeded_and_in_range():
    counts = torch.tensor([0, 1, 7, 640])
    a = ransac.draw_ranks(counts, 100)
    b = ransac.draw_ranks(counts, 100, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (4, 100, 3)
    assert bool((a >= 0).all()) and bool((a < torch.clamp(counts, min=1)[:, None, None]).all())
    assert int(a[3].unique().numel()) > 100


def test_refine_batch_is_refine_labels_per_frame():
    pts, labels, cell_lab, W, P = chunk_scene()
    cfg = scene_config(0.5)
    pts2 = torch.from_numpy(np.stack([pts, pts[::-1].copy()]))
    lab2 = torch.from_numpy(np.stack([labels, labels]))
    cells2 = torch.from_numpy(np.stack([cell_lab, cell_lab]))
    got = ransac.refine_batch(pts2, lab2, cells2, W, P, cfg)
    for b in range(2):
        one = ransac.refine_labels(pts2[b], lab2[b], cfg, cell_labels=cells2[b],
                                   image_width=W, patch_size=P)
        torch.testing.assert_close(got[b], one, rtol=0, atol=0)


# ------------------------------------------------- the shipped ini, end to end

@pytest.fixture(scope="module")
def ransac_config():
    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini"))
    assert cfg.ransac_refinement and abs(cfg.ransac_inliers_ratio - 0.15) < 1e-6
    return cfg


def test_shipped_ini_golden_f1_and_mass(tum_cloud, ransac_config):
    """tests/test_refinement.py's bounds, held over eight seeded streams of
    draws: golden F1 >= 0.30 on their mean and the survivor mass within
    [0.4, 1.6] of the reference build's on each; refinement only removes
    labels. At the 1-unit threshold a single stream's F1 is noise around the
    bound (0.23-0.50 over 40 seeds, no-op refinement 0.21), so the bound is
    held on the mean; the default stream is seed 0's."""
    from deplex_tpu_torch.ops.merge import apply_label_lut, rasterize_labels
    from deplex_tpu_torch.pipeline import compute_cell_stats, grow_planes, merge_stage

    pts, h, w = tum_cloud
    cfg, P = ransac_config, ransac_config.patch_size
    labels = PlaneExtractor(h, w, cfg, device="cpu").process(pts)
    src = torch.from_numpy(pts).reshape(1, h, w, 3)
    lm, seg = grow_planes(compute_cell_stats(src, None, cfg), cfg)
    ml = merge_stage(lm, seg, cfg)
    coarse, cells = rasterize_labels(lm, ml, h, w, P)[0], apply_label_lut(lm, ml)[0]
    changed = labels != coarse.numpy()
    assert changed.any() and (labels[changed] == 0).all()

    counts = torch.bincount(cells.reshape(-1).long(), minlength=cfg.max_planes + 1)
    gold = np.load(DATA / "golden" / "tum_ransac_labels.npz")["labels"]
    kept_gold = int((gold > 0).sum())
    f1s = []
    for seed in range(8):
        draws = ransac.draw_ranks(counts[1:] * P * P, cfg.ransac_max_iterations,
                                  torch.Generator().manual_seed(seed))
        got = labels if seed == 0 else ransac.refine_labels(
            src.reshape(-1, 3), coarse, cfg, draws=draws, cell_labels=cells,
            image_width=w, patch_size=P).numpy()
        kept = int((got > 0).sum())
        assert 0.4 * kept_gold <= kept <= 1.6 * kept_gold, (seed, kept, kept_gold)
        f1s.append(label_f1(got, gold)[0])
    assert np.mean(f1s) >= 0.30, f1s


def test_shipped_ini_depth_entries_agree(tum_image, ransac_config):
    """The depth entries run stage 6 on back-projected points: the single
    frame and a batch of one give the same labels."""
    depth, K = tum_image
    one = PlaneExtractor(480, 640, ransac_config, device="cpu").process_depth(depth, K)
    batch = BatchDepthExtractor(480, 640, ransac_config, batch=1, device="cpu").process(
        depth[None], K)
    np.testing.assert_array_equal(batch[0].astype(np.int32), one)
    assert 0 < int((one > 0).sum()) < one.size


# -------------------------------------- the batched loop of fixed trip count

def scene_batch():
    """Two chunking scenes (other seeds: other cells and depths) as a batch."""
    frames = [chunk_scene(seed) for seed in (7, 11)]
    W, P = frames[0][3], frames[0][4]
    pts, labels, cells = (np.stack([f[i] for f in frames]) for i in range(3))
    return pts, labels, cells, W, P


def batch_jax_draws(cells, P, K=192):
    """Each frame's draws as the JAX package's vmapped refine_labels makes them."""
    return torch.stack([jax_draws(np.bincount(c.ravel(), minlength=5)[1:] * P * P, 4, K)
                        for c in cells])


@pytest.mark.parametrize("ratio", [0.15, 0.5, 1.0])
def test_batched_fixed_trip_loop_equals_jax_refine_batch(ratio):
    """refine_cells over two frames, every chunk run with the early exit on
    the device's terms, against the JAX package's vmapped _refine_batch fed
    the same draws: equal labels."""
    from deplex_tpu.parallel.batch import _refine_batch

    pts, labels, cells, W, P = scene_batch()
    H = pts.shape[1] // W
    ref = np.asarray(_refine_batch(jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(cells),
                                   H, W, scene_config(ratio, JaxConfig)))
    got, scored = ransac.refine_cells(torch.from_numpy(pts), torch.from_numpy(labels),
                                      torch.from_numpy(cells), W, P, scene_config(ratio),
                                      draws=batch_jax_draws(cells, P), fixed_trip=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert scored.dtype == torch.int32 and scored.shape == (2,)
    assert all(0 < int((ref[b] > 0).sum()) < int((labels[b] > 0).sum()) for b in range(2))


@pytest.mark.parametrize("chunk", [64, 50], ids=["chunk64", "chunk50_padded"])
def test_fixed_trip_and_early_stop_agree(chunk):
    """The loop of fixed trip count (the card's) and the one that stops on a
    host check (the CPU's) give equal labels and score the same chunks per
    frame, also when the last chunk is padded; with ratio 0.15 some frame
    stops before the last chunk."""
    pts, labels, cells, W, P = scene_batch()
    args = (torch.from_numpy(pts), torch.from_numpy(labels), torch.from_numpy(cells), W, P,
            scene_config(0.15))
    draws = batch_jax_draws(cells, P)
    fixed, fixed_scored = ransac.refine_cells(*args, draws=draws, chunk_size=chunk,
                                              fixed_trip=True)
    early, early_scored = ransac.refine_cells(*args, draws=draws, chunk_size=chunk,
                                              fixed_trip=False)
    torch.testing.assert_close(fixed, early, rtol=0, atol=0)
    torch.testing.assert_close(fixed_scored, early_scored, rtol=0, atol=0)
    chunks = -(-192 // chunk)
    assert int(fixed_scored.min()) >= 1 and int(fixed_scored.min()) < chunks


def test_chunk_twin_counts_equal_a_direct_count_and_zero_when_done():
    """chunk_outliers_reference (the kernel's contract) against a direct
    per-plane count in numpy, same float32 order: equal integers for a frame
    being scored, zeros for a done one; scored counts the frames scored."""
    pts, _, cells, W, P = scene_batch()
    rng = np.random.default_rng(5)
    B, (gh, gw), MAXP, Kc, S = 2, cells.shape[1:], 4, 16, 3
    cells = cells.astype(np.int32)
    cells[0, 0, :3] = [0, 5, -1]                   # ids outside 1..MAXP count nothing
    n = rng.normal(size=(B, MAXP, S * Kc, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(-3000, 3000, (B, MAXP, S * Kc)).astype(np.float32)
    thr = 400.0
    done = torch.tensor([False, True])
    scored = torch.zeros(2, dtype=torch.int32)
    got = ransac.chunk_outliers_reference(
        torch.from_numpy(pts), torch.from_numpy(cells), torch.from_numpy(n), torch.from_numpy(d),
        done, scored, s=1, chunk=Kc, threshold=thr, image_width=W, patch_size=P)
    assert got.dtype == torch.int32 and got.shape == (B, MAXP, Kc)
    img = pts[0].reshape(-1, W, 3)[:gh * P, :gw * P]
    pix_label = np.repeat(np.repeat(cells[0], P, 0), P, 1)
    want = np.zeros((MAXP, Kc), np.int64)
    for p in range(MAXP):
        x, y, z = (img[pix_label == p + 1][:, i][:, None] for i in range(3))
        nk, dk = n[0, p, Kc:2 * Kc], d[0, p, Kc:2 * Kc]
        e = x * nk[:, 0]
        e = e + y * nk[:, 1]
        e = e + z * nk[:, 2]
        e = e + dk
        want[p] = (~(np.abs(e) < np.float32(thr))).sum(0)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert 0 < want.sum() < (pix_label >= 1).sum() * Kc
    assert int(got[1].abs().sum()) == 0
    assert scored.tolist() == [1, 0]


# ------------------------------------------- the chunk step (kernel contract)

def plain_loop_states(score, n_pts, ratio, n_chunks, chunk):
    """The early-exit loop as it stood before the chunk step (its scorer
    counts, plain ops update every frame): the state after each chunk."""
    B, MAXP = n_pts.shape
    target = ratio * n_pts
    cols = torch.arange(chunk)
    reached = torch.zeros((B, MAXP), dtype=torch.bool)
    run_best = torch.full((B, MAXP), float("-inf"))
    best_loss = torch.full((B, MAXP), float("inf"))
    best_k = torch.zeros((B, MAXP), dtype=torch.int64)
    scored = torch.zeros((B,), dtype=torch.int32)
    for s in range(n_chunks):
        done = reached.all(1)
        loss = score(s, done, scored).to(torch.float32)
        inliers = n_pts[..., None] - loss
        run = torch.cummax(torch.maximum(inliers, run_best[..., None]), 2).values
        hit = run >= target[..., None]
        any_hit = hit.any(2)
        stop = torch.where(any_hit, torch.argmax(hit.to(torch.int32), 2),
                           torch.full_like(best_k, chunk - 1))
        prefix = torch.where(cols <= stop[..., None], loss, torch.full_like(loss, float("inf")))
        j = torch.argmin(prefix, 2)
        pl = torch.gather(prefix, 2, j[..., None])[..., 0]
        upd = (~reached) & (pl < best_loss)
        best_loss = torch.where(upd, pl, best_loss)
        best_k = torch.where(upd, s * chunk + j, best_k)
        reached = reached | any_hit
        run_best = torch.maximum(run_best, run[..., -1])
        yield dict(best_k=best_k, best_loss=best_loss, reached=reached, run_best=run_best,
                   done=reached.all(1), scored=scored.clone(), loss=loss.to(torch.int32),
                   live=~done)


def step_case(kind):
    """(points, cell labels, draws, ratio, chunk) of a two-frame chunking
    scene for one kind of chunk-step case."""
    pts, _, cells, W, P = scene_batch()
    cells = cells.astype(np.int32)
    draws = batch_jax_draws(cells, P)
    ratio, chunk = {"ratio_0.15": (0.15, 64), "ratio_0.5": (0.5, 64), "ratio_1.0": (1.0, 64),
                    "padded_chunk50": (0.5, 50), "done_early": (0.15, 32),
                    "empty_plane": (0.5, 64), "tied_losses": (1.0, 64)}[kind]
    if kind == "empty_plane":            # plane 3 has no cells in frame 0
        cells[0][cells[0] == 3] = 0
        draws = batch_jax_draws(cells, P)
    if kind == "tied_losses":            # hypotheses repeat every 8: equal losses
        draws = draws[:, :, :8].repeat(1, 1, 24, 1)
    return pts, cells, draws, ratio, chunk, W, P


STEP_KINDS = ["ratio_0.15", "ratio_0.5", "ratio_1.0", "padded_chunk50", "done_early",
              "empty_plane", "tied_losses"]


@pytest.mark.parametrize("kind", STEP_KINDS)
def test_chunk_step_twin_leaves_the_plain_loop_state(kind):
    """chunk_step_reference (the kernel's twin), chunk by chunk, against the
    loop it replaced on the same hypotheses: equal counts, best_k,
    best_loss, reached, done and scored after every chunk. run_best is
    equal on the frames scored; a done frame's state is frozen (as the
    JAX package's vmapped while_loop freezes a finished frame's carry),
    where the old loop lifted its run_best, which nothing read."""
    pts, cells, draws, ratio, chunk, W, P = step_case(kind)
    cfg = scene_config(ratio)
    pts_t, cells_t = torch.from_numpy(pts), torch.from_numpy(cells)
    hyp, counts, order, bounds, Kc, S = ransac.sample_hypotheses(
        pts_t, cells_t, W, P, cfg, draws=draws, chunk_size=chunk)
    assert (Kc, S) == (chunk, -(-192 // chunk)) and hyp.shape == (2, 4, S * Kc, 4)
    n_pts = counts.to(torch.float32)
    ratio_t = torch.tensor(ratio, dtype=torch.float32)
    kw = dict(chunk=Kc, threshold=cfg.ransac_threshold, image_width=W, patch_size=P)

    def score(s, done, scored):
        return ransac.chunk_outliers_reference(pts_t, cells_t, hyp[..., :3], hyp[..., 3], done,
                                               scored, s=s, **kw)

    state = ransac.new_chunk_state(n_pts, ratio_t, Kc)
    losses = torch.full((2, 4, Kc), -1, dtype=torch.int32)
    chunk0 = None
    for s, old in enumerate(plain_loop_states(score, n_pts, ratio_t, S, Kc)):
        run_best_before = state.run_best.clone()
        ransac.chunk_step_reference(pts_t, cells_t, hyp, order, bounds, state, s=s,
                                    losses=losses, **kw)
        live = old["live"]
        torch.testing.assert_close(losses[live], old["loss"][live], rtol=0, atol=0)
        for name in ("best_k", "best_loss", "reached", "done", "scored"):
            torch.testing.assert_close(getattr(state, name), old[name], rtol=0, atol=0)
        torch.testing.assert_close(state.run_best[live], old["run_best"][live], rtol=0, atol=0)
        torch.testing.assert_close(state.run_best[~live], run_best_before[~live], rtol=0,
                                   atol=0)
        assert int(state.counts.abs().sum()) == 0 and int(state.tickets.abs().sum()) == 0
        chunk0 = losses.clone() if s == 0 else chunk0
    if kind == "done_early":
        assert int(state.scored.min()) < S and bool(state.done.all())
    if kind == "empty_plane":
        assert float(n_pts[0, 2]) == 0 and bool(state.reached[0, 2])
        assert int(state.best_k[0, 2]) == 0 and int(state.scored[0]) >= 1
    if kind == "tied_losses":
        # Hypotheses k and k + 8 are one plane, so every loss ties with the
        # ones 8 apart, and the minimum of any prefix first occurs below 8:
        # the first index on ties must win, in every plane.
        torch.testing.assert_close(chunk0[..., 8:16], chunk0[..., :8], rtol=0, atol=0)
        assert bool((state.best_k < 8).all()), state.best_k


def test_chunk_step_wrapper_checks_and_runs_the_twin_on_the_cpu():
    """kernels.ransac.chunk_step: the twin for CPU tensors; a device it does
    not take, or a state tensor of the wrong dtype or shape, raises."""
    from deplex_tpu_torch.kernels import ransac as k_ransac

    pts, cells, draws, ratio, chunk, W, P = step_case("ratio_0.5")
    cfg = scene_config(ratio)
    pts_t, cells_t = torch.from_numpy(pts), torch.from_numpy(cells)
    hyp, counts, order, bounds, Kc, S = ransac.sample_hypotheses(
        pts_t, cells_t, W, P, cfg, draws=draws, chunk_size=chunk)
    ratio_t = torch.tensor(ratio, dtype=torch.float32)
    kw = dict(chunk=Kc, threshold=cfg.ransac_threshold, image_width=W, patch_size=P)
    args = (pts_t, cells_t, hyp, order, bounds)
    got, ref = (ransac.new_chunk_state(counts.to(torch.float32), ratio_t, Kc) for _ in range(2))
    before = k_ransac.launches
    for s in range(S):
        k_ransac.chunk_step(*args, got, s=s, **kw)
        ransac.chunk_step_reference(*args, ref, s=s, **kw)
    assert k_ransac.launches == before          # the twin ran: no launch
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert k_ransac.check_inputs(*args, got, s=0, chunk=Kc, image_width=W, patch_size=P) == 40
    bad = got._replace(best_k=got.best_k.to(torch.int32))
    with pytest.raises(ValueError, match="state.best_k"):
        k_ransac.check_inputs(*args, bad, s=0, chunk=Kc, image_width=W, patch_size=P)
    bad = got._replace(counts=got.counts[:, :, :-1])
    with pytest.raises(ValueError, match="state.counts"):
        k_ransac.check_inputs(*args, bad, s=0, chunk=Kc, image_width=W, patch_size=P)
    with pytest.raises(ValueError, match="outside"):
        k_ransac.check_inputs(*args, got, s=S, chunk=Kc, image_width=W, patch_size=P)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="unsupported device"):
        k_ransac.chunk_step(*meta, ransac.ChunkState(*(t.to("meta") for t in got)), s=0, **kw)
