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
import torch

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
