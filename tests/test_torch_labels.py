"""The pixel-labels kernel's wrapper (deplex_tpu_torch.kernels.labels) on
the CPU, where it runs its plain twin, vs the JAX package.

Stage 5 against deplex_tpu.ops.merge.rasterize_labels under jax.vmap at
several patch sizes, with remainder strips and label tables up to 300 (the
uint8 output against ``.astype(jnp.uint8)``); stage 6's final pass, the
kernel's refine mode through the pipeline's stage call, against
deplex_tpu.ops.ransac.refine_labels fed the JAX package's own draws; the
primitives' cylinder mask on the cells against the pixel-level ``where``
it replaced; the wrapper's errors; and a pure-Python model of the CUDA
kernel's thread-to-pixel mapping (a block a band of P rows of a frame,
its row of labels built once, then 16-byte vectors of the band's flat
range, each split into row and column) against the twin at odd and
aligned widths. Labels are integers: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu import Config as JaxConfig
from deplex_tpu.ops import ransac as jransac
from deplex_tpu.ops.merge import apply_label_lut as jax_apply_label_lut
from deplex_tpu.ops.merge import rasterize_labels as jax_rasterize
from deplex_tpu.parallel.batch import extract_depth_batch_jit as jax_extract_depth_batch_jit
from deplex_tpu_torch import Config, kernels
from deplex_tpu_torch.kernels.labels import check_launch, pixel_labels, winners
from deplex_tpu_torch.ops.merge import apply_label_lut, pixel_labels_reference, rasterize_labels
from deplex_tpu_torch.parallel.batch import extract_depth_batch, extract_depth_batch_jit
from deplex_tpu_torch.pipeline import PlaneCells, refine_stage

from .test_torch_ransac import chunk_scene, jax_draws, scene_config


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def random_case(seed: int, B: int, gh: int, gw: int, M: int):
    """Seeded (B, gh, gw) int32 cell labels in 0..M (about a third 0) and
    (B, M) int32 merge labels in 0..M-1."""
    rng = np.random.default_rng(seed)
    lm = rng.integers(1, M + 1, (B, gh, gw)).astype(np.int32)
    lm[rng.random((B, gh, gw)) < 0.35] = 0
    ml = rng.integers(0, M, (B, M)).astype(np.int32)
    return lm, ml


def jax_pixel_labels(lm, ml, H, W, P, dtype):
    out = jax.vmap(lambda l, m: jax_rasterize(l, m, H, W, P))(jnp.asarray(lm), jnp.asarray(ml))
    return np.asarray(out.astype(jnp.uint8) if dtype == torch.uint8 else out)


# ------------------------------------------------------- stage 5 against JAX

@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["uint8", "int32"])
@pytest.mark.parametrize("M", [34, 255, 300])
@pytest.mark.parametrize("P, rem", [(3, (2, 1)), (4, (0, 0)), (8, (5, 7)), (10, (3, 0))],
                         ids=["p3", "p4", "p8", "p10"])
def test_stage5_equals_jax_rasterize(P, rem, M, dtype):
    """Every pixel: merge_labels[cell - 1] + 1, 0 for cell 0 and in the
    remainder strips; uint8 keeps the low 8 bits (M = 300 wraps)."""
    B, gh, gw = 3, 5, 7
    H, W = gh * P + rem[0], gw * P + rem[1]
    lm, ml = random_case(P * 1000 + M, B, gh, gw, M)
    got = pixel_labels(torch.from_numpy(lm), torch.from_numpy(ml), H, W, P, dtype)
    assert got.dtype == dtype and got.shape == (B, H * W)
    np.testing.assert_array_equal(got.numpy(), jax_pixel_labels(lm, ml, H, W, P, dtype))
    if rem != (0, 0):
        img = got.numpy().reshape(B, H, W)
        assert not img[:, gh * P:].any() and not img[:, :, gw * P:].any()


def test_all_zero_cells_write_zero():
    lm = np.zeros((2, 4, 6), np.int32)
    ml = np.arange(8, dtype=np.int32)[None].repeat(2, 0)
    for dtype in (torch.uint8, torch.int32):
        got = pixel_labels(torch.from_numpy(lm), torch.from_numpy(ml), 43, 61, 10, dtype)
        assert got.shape == (2, 43 * 61) and not got.any()
        np.testing.assert_array_equal(got.numpy(), jax_pixel_labels(lm, ml, 43, 61, 10, dtype))


def test_whole_slice_uint8_equals_jax(tum_image):
    """The serving entry (stages 1-5, uint8 written by the labels stage) on
    a B=2 batch of a 240x320 crop of the TUM frame, against the JAX
    package's extract_depth_batch_jit; the int32 entry is its widening."""
    depth, K = tum_image
    crop = np.ascontiguousarray(depth[120:360, 160:480])
    batch = np.stack([crop, np.roll(crop, (3, 5), (0, 1))])
    ref = np.asarray(jax_extract_depth_batch_jit(jnp.asarray(batch), jnp.asarray(K),
                                                 config=JaxConfig()))
    d = torch.from_numpy(batch.view(np.int16)).view(torch.uint16)
    got = extract_depth_batch_jit(d, K, config=Config())
    assert got.dtype == torch.uint8 and ref.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy()[0], ref[0])
    assert int(got.max()) > 0
    np.testing.assert_array_equal(extract_depth_batch(d, K, Config()).numpy(),
                                  got.numpy().astype(np.int32))


# ------------------------------------------------ stage 6's pass against JAX

def merged_scene():
    """chunk_scene's 4-plane scene with a merge table that folds plane 2
    into 1 and plane 4 into 3: (points, cell labels, merge labels, W, P)."""
    pts, _, cell_lab, W, P = chunk_scene()
    return pts, cell_lab, np.array([0, 0, 2, 2], np.int32), W, P


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["uint8", "int32"])
@pytest.mark.parametrize("ratio", [0.15, 0.5, 1.0])
def test_stage6_pass_equals_jax_refine_labels(ratio, dtype, monkeypatch):
    """The pipeline's stage 6 (sampling on the merged cell labels, the
    chunk loop, then the final pass in the labels stage from the cell labels
    and the winners) against JAX's refine_labels on the rasterized merged
    labels, both fed JAX's draws (the port's in place of its default
    stream's)."""
    from deplex_tpu_torch.ops import ransac
    pts, lm, ml, W, P = merged_scene()
    H = pts.shape[0] // W
    cells_j = jax_apply_label_lut(jnp.asarray(lm), jnp.asarray(ml))
    labels_j = jax_rasterize(jnp.asarray(lm), jnp.asarray(ml), H, W, P)
    ref = np.asarray(jransac.refine_labels(
        jnp.asarray(pts), labels_j, scene_config(ratio, JaxConfig), cell_labels=cells_j,
        image_width=W, patch_size=P, chunk_size=64))
    counts = np.bincount(np.asarray(cells_j).ravel(), minlength=5)[1:] * P * P
    planes = PlaneCells(torch.from_numpy(lm)[None], torch.from_numpy(ml)[None],
                        torch.from_numpy(pts)[None])
    draws = jax_draws(counts, 4, 192)
    monkeypatch.setattr(ransac, "draw_ranks", lambda *args, **kwargs: draws)
    kernels.reset_launch_counts()
    got, scored = refine_stage(planes, H, W, scene_config(ratio), dtype)
    assert got.dtype == dtype and scored.shape == (1,)
    np.testing.assert_array_equal(got[0].numpy(), ref.astype(got.numpy().dtype))
    assert 0 < int((ref > 0).sum()) < int((np.asarray(labels_j) > 0).sum())
    assert all(n == 0 for n in kernels.launch_counts().values())   # the CPU twins


def test_stage6_pass_is_the_plain_pass_on_rasterized_labels():
    """The twin's refine mode is refine_cells' default final pass over the
    rasterized labels, for the same winners, at every threshold."""
    from deplex_tpu_torch.ops.ransac import inlier_labels, refine_cells

    pts, lm, ml, W, P = merged_scene()
    H = pts.shape[0] // W
    lm_t, ml_t, pts_t = (torch.from_numpy(a)[None] for a in (lm, ml, pts))
    cfg = scene_config(0.5)
    cells = apply_label_lut(lm_t, ml_t)
    refine, _ = refine_cells(pts_t, None, cells, W, P, cfg, write=lambda *w: w)
    points, hyp, best_k, _ = refine
    best = winners(hyp, best_k)
    labels = rasterize_labels(lm_t, ml_t, H, W, P)
    for thr in (0.5, 5.0, 50.0):
        want = inlier_labels(points, labels, best[..., :3], best[..., 3], torch.full((), thr))
        got = pixel_labels(lm_t, ml_t, H, W, P, torch.int32, refine=(points, hyp, best_k, thr))
        assert torch.equal(got, want)
    default, _ = refine_cells(pts_t, labels, cells, W, P, cfg)
    assert torch.equal(pixel_labels(lm_t, ml_t, H, W, P, refine=refine), default)


# -------------------------------------------------- the primitives' mask

@pytest.mark.parametrize("P, rem", [(8, (0, 0)), (5, (3, 4))], ids=["p8", "p5_remainder"])
def test_cylinder_mask_on_cells_equals_pixel_where(P, rem):
    """pipeline.primitive_stages masks the plane cells a cylinder holds
    before the labels kernel; the old pixel-level where gave the same."""
    B, gh, gw, M, C = 1, 9, 12, 16, 4
    H, W = gh * P + rem[0], gw * P + rem[1]
    lm, ml = random_case(11, B, gh, gw, M)
    rng = np.random.default_rng(12)
    cyl = rng.integers(1, C + 1, (B, gh, gw)).astype(np.int32)
    cyl[rng.random((B, gh, gw)) < 0.7] = 0
    lm_t, ml_t, cyl_t = map(torch.from_numpy, (lm, ml, cyl))
    ident = torch.arange(C, dtype=torch.int32).expand(1, -1)
    planes_px = rasterize_labels(lm_t, ml_t, H, W, P)
    cyl_px = rasterize_labels(cyl_t, ident, H, W, P)
    old = torch.where(cyl_px > 0, torch.zeros_like(planes_px), planes_px)
    new = pixel_labels(torch.where(cyl_t > 0, torch.zeros_like(lm_t), lm_t), ml_t, H, W, P)
    assert torch.equal(new, old) and bool((old > 0).any()) and bool((cyl_px > 0).any())
    assert torch.equal(pixel_labels(cyl_t, ident, H, W, P), cyl_px)


# ----------------------------------------------------------- the wrapper

def _good():
    lm, ml = random_case(3, 2, 4, 5, 8)
    pts = torch.zeros((2, 40 * 50, 3))
    hyp, best_k = torch.zeros((2, 8, 5, 4)), torch.zeros((2, 8), dtype=torch.int64)
    return torch.from_numpy(lm), torch.from_numpy(ml), pts, (hyp, best_k)


@pytest.mark.parametrize("bad, match", [
    (lambda lm, ml, p, b: dict(labels_map=lm.long()), "labels_map must be"),
    (lambda lm, ml, p, b: dict(labels_map=lm[0]), "labels_map must be"),
    (lambda lm, ml, p, b: dict(merge_labels=ml.float()), "merge_labels must be"),
    (lambda lm, ml, p, b: dict(merge_labels=ml[:1]), "merge_labels must be"),
    (lambda lm, ml, p, b: dict(image_height=39), "do not fit"),
    (lambda lm, ml, p, b: dict(image_width=49), "do not fit"),
    (lambda lm, ml, p, b: dict(dtype=torch.float32), "dtype must be"),
    (lambda lm, ml, p, b: dict(dtype=torch.int64), "dtype must be"),
    (lambda lm, ml, p, b: dict(refine=(p[:, :-1], *b, 1.0)), "points must be"),
    (lambda lm, ml, p, b: dict(refine=(p.double(), *b, 1.0)), "points must be"),
    (lambda lm, ml, p, b: dict(refine=(p, b[0][:, :4], b[1], 1.0)), "hyp must be"),
    (lambda lm, ml, p, b: dict(labels_map=lm.to("meta"), merge_labels=ml.to("meta")),
     "unsupported device"),
    (lambda lm, ml, p, b: dict(merge_labels=ml.to("meta")), "merge_labels must be"),
    (lambda lm, ml, p, b: dict(refine=(p, b[0], b[1].int(), 1.0)), "best_k must be"),
    (lambda lm, ml, p, b: dict(image_width=58113, card_only=True), "shared memory"),
], ids=["cells_int64", "cells_2d", "merge_float", "merge_batch", "height", "width",
        "float_out", "int64_out", "points_shape", "points_double", "best_shape",
        "meta_device", "mixed_devices", "best_k_int32", "row_too_wide"])
def test_wrapper_raises(bad, match):
    lm, ml, pts, best = _good()
    args = dict(labels_map=lm, merge_labels=ml, image_height=40, image_width=50,
                patch_size=10, dtype=torch.int32, refine=None)
    args.update(bad(lm, ml, pts, best))
    before = kernels.labels.launches
    with pytest.raises(ValueError, match=match):
        if args.pop("card_only", False):     # the kernel's limit: the card's path alone
            check_launch(args["image_width"], ml.shape[1], args["dtype"], args["refine"])
        else:
            pixel_labels(**args)
    assert kernels.labels.launches == before


@pytest.mark.parametrize("refine", [False, True], ids=["stage5", "stage6"])
def test_a_row_past_the_kernels_shared_memory_runs_the_twin_on_the_cpu(refine):
    """W = 58,113 int32 labels (a row past a block's 227 KB): the kernel's
    limit is checked on the card's path only; on the CPU the wrapper gives
    the twin's labels."""
    H, W, P = 4, 58113, 2
    lm, ml = random_case(21, 1, 2, 29056, 5)
    lm_t, ml_t = torch.from_numpy(lm), torch.from_numpy(ml)
    stage6 = None
    if refine:
        rng = np.random.default_rng(22)
        pts = torch.from_numpy(rng.normal(0, 3, (1, H * W, 3)).astype(np.float32))
        hyp = torch.from_numpy(rng.normal(0, 1, (1, 5, 3, 4)).astype(np.float32))
        stage6 = (pts, hyp, torch.from_numpy(rng.integers(0, 3, (1, 5))), 2.0)
    with pytest.raises(ValueError, match="shared memory"):
        check_launch(W, 5, torch.int32, stage6)
    got = pixel_labels(lm_t, ml_t, H, W, P, torch.int32, refine=stage6)
    want = pixel_labels_reference(lm_t, ml_t, H, W, P, torch.int32, stage6 and (
        stage6[0], winners(stage6[1], stage6[2]), stage6[3]))
    assert torch.equal(got, want) and bool((got > 0).any())


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["uint8", "int32"])
def test_stage6_contract_is_the_gather_and_the_pass(dtype):
    """The wrapper's stage-6 contract, (points, hyp, best_k, threshold): on
    the CPU it equals the twin handed the gathered winners hyp[b, m,
    best_k[b, m]], at several thresholds, with winners anywhere in the
    table (the first, the last, degenerate padding rows); exact."""
    rng = np.random.default_rng(23)
    B, gh, gw, M, P, n_hyp = 2, 5, 7, 6, 4, 9
    H, W = gh * P + 1, gw * P + 2
    lm, ml = random_case(24, B, gh, gw, M)
    pts = rng.normal(0, 2, (B, H * W, 3)).astype(np.float32)
    hyp = rng.normal(0, 1, (B, M, n_hyp, 4)).astype(np.float32)
    hyp[:, :, -1] = [0, 0, 0, 1e30]                        # the padding's rows
    best_k = rng.integers(0, n_hyp, (B, M))
    best_k[0, :3] = [0, n_hyp - 1, n_hyp - 1]
    lm_t, ml_t, pts_t, hyp_t, k_t = map(torch.from_numpy, (lm, ml, pts, hyp, best_k))
    gathered = hyp[np.arange(B)[:, None], np.arange(M)[None], best_k]
    assert torch.equal(winners(hyp_t, k_t), torch.from_numpy(gathered))
    for thr in (0.5, 2.0, 1e31):
        got = pixel_labels(lm_t, ml_t, H, W, P, dtype, refine=(pts_t, hyp_t, k_t, thr))
        want = pixel_labels_reference(lm_t, ml_t, H, W, P, dtype,
                                      (pts_t, torch.from_numpy(gathered), thr))
        assert torch.equal(got, want)
    assert bool((got > 0).any())


def test_wrapper_runs_the_twin_on_the_cpu():
    lm, ml, pts, (hyp, best_k) = _good()
    before = kernels.labels.launches
    got = pixel_labels(lm, ml, 40, 50, 10, torch.uint8, refine=(pts, hyp, best_k, 1.0))
    assert kernels.labels.launches == before
    assert torch.equal(got, pixel_labels_reference(lm, ml, 40, 50, 10, torch.uint8,
                                                   (pts, winners(hyp, best_k), 1.0)))
    assert "pixel_labels" in kernels.PLANE_KERNELS and "pixel_labels" in kernels.MODULES


# ------------------------------------- a model of the kernel's mapping

def kernel_model(lm, ml, H, W, P, itemsize, threads=256):
    """csrc/labels.cu in Python: a grid of (bands, B), a band the P rows of
    one cell row or the rows past gh*P; a block first writes the band's
    row of W labels (column c in cell c // P, LUT'd, 0 past gw*P and in the
    rows past gh*P), then streams it over the band's rows: where a row is a
    multiple of 16 bytes, thread t takes the 16-byte vectors at band offsets
    (t + k * threads) * V, each inside one row (its column e % W), else the
    single labels t + k * threads. lut[0] = 0; a cell label outside 0..M
    writes 0. Returns the labels and the number of vector stores."""
    B, gh, gw = lm.shape
    M = ml.shape[1]
    V = 16 // itemsize
    out = np.full(B * H * W, -1, np.int64)
    vectors = 0
    bands = gh + (1 if H > gh * P else 0)
    for b in range(B):
        lut = np.zeros(M + 2, np.int64)
        lut[1:M + 1] = ml[b].astype(np.int64) + 1
        for band in range(bands):
            cell_band = band < gh
            r0 = band * P
            rows = P if cell_band else H - r0
            row = np.zeros(W, np.int64)
            for c in range(W):
                k = lm[b, band, c // P] if cell_band and c // P < gw else 0
                row[c] = lut[k] if 0 < k <= M else 0
            o, n = (b * H + r0) * W, rows * W
            if (W * itemsize) % 16 == 0:
                for t in range(threads):
                    for e in range(t * V, n, threads * V):
                        col = e % W
                        assert col + V <= W              # the vector stays in its row
                        assert (out[o + e:o + e + V] == -1).all()
                        out[o + e:o + e + V] = row[col:col + V]
                        vectors += 1
            else:
                for t in range(threads):
                    for e in range(t, n, threads):
                        assert out[o + e] == -1          # each label written once
                        out[o + e] = row[e % W]
    assert (out >= 0).all()                              # every label written
    return out.reshape(B, H * W), vectors


@pytest.mark.parametrize("threads", [256, 3], ids=["threads256", "threads3"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["uint8", "int32"])
@pytest.mark.parametrize("H, W, P", [(7, 9, 3), (11, 13, 2), (10, 16, 4), (5, 32, 5),
                                     (23, 48, 10)])
def test_kernel_mapping_model_equals_the_twin(H, W, P, dtype, threads):
    """Odd widths (rows that are no multiple of 16 bytes: the label-by-label
    path) and widths of 16 and 48 (the vector path for uint8 and int32),
    with remainder rows and columns; blocks of 3 threads take several steps
    a band."""
    B, gh, gw = 3, H // P, W // P
    lm, ml = random_case(H * W + P, B, gh, gw, 6)
    lm[0, 0, 0] = 7                                  # past the table: written as 0
    itemsize = torch.empty((), dtype=dtype).element_size()
    got, vectors = kernel_model(lm, ml, H, W, P, itemsize, threads)
    assert (vectors > 0) == ((W * itemsize) % 16 == 0)
    lm[0, 0, 0] = 0
    want = pixel_labels(torch.from_numpy(lm), torch.from_numpy(ml), H, W, P, torch.int32)
    np.testing.assert_array_equal(got, want.numpy())
