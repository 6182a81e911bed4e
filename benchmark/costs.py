"""Bytes and float32 operations of each stage of a call, and the least time
the H100 could take for them: the yardstick of ``call_roofline_pct``.

The counts are copies of the port's measurement tool
(``deplex_tpu_torch/tools/kernel_bench.py``: ``moments_cost``,
``cells_cost``, ``rounds_cost``, ``round_cost``, ``merge_cost``,
``labels_cost``, ``sampling_cost``, ``ransac_cost``), read from the shapes
of a batch and from the reference's own intermediates (``stages.Record``),
never from the program's. Each input byte is counted read once and each
output byte written once; where the work depends on the data (the labelled
pixels stage 6 scores, the frames its early exit has not stopped, the
pixels its draws reach), what this batch needs is counted. A stage's least
time is the larger of its bytes over the HBM rate and its operations over
the float32 rate (a fused multiply-add counts two; the chunk step's
multiplies and adds, which do not fuse, one each).
"""

from __future__ import annotations

import torch

from benchmark.reference.cellstats import moments_band_plan_exists, patch_size
from benchmark.reference.merge import rasterize_labels
from benchmark.reference.ransac import sample_pixels
from benchmark.reference.stages import Record

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# The plane tables of PlaneSegments that K3 reads and writes.
_TABLES = ("n", "coord_sum", "scatter", "normal", "mean", "d")
# Bytes a cell the cell-finalize kernel writes (planar 1, normal and mean 12
# each, d, mse, tol and the bin 4 each, the edge 1) and the copies of its
# input planes that CellStats holds (coord_sum 12, scatter 36).
CELL_FINALIZE_OUT_BYTES = 1 + 2 * 12 + 4 * 4 + 1
CELL_FINALIZE_COPY_BYTES = 12 + 36


def least_s(nbytes: float, flops: float = 0.0) -> float:
    """The least seconds on the H100 for `nbytes` moved and `flops` float32
    operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def moments_cost(depth: torch.Tensor, config) -> tuple[int, int]:
    """K1: the depth read once and the 13 planes written once; per pixel 2
    back-projection multiplies, 4 sums and 18 anchored (or 15 centered)
    operations, plus the 13 column partials added per in-cell column."""
    B, H, W = depth.shape[:3]
    P = patch_size(H, W, config)
    gh, gw = H // P, W // P
    anchored = moments_band_plan_exists(gh, P, gw * P)
    pixels = B * gh * gw * P * P
    per_pixel = 2 + 4 + (18 if anchored else 15)
    nbytes = depth.numel() * depth.element_size() + 13 * B * gh * gw * 4
    return nbytes, pixels * per_pixel + B * gh * gw * 13 * P


def cells_cost(cells: int) -> int:
    """Cell finalize: the 13 moment planes read once, every output written
    once (its double-precision work is a fraction of this at 3.35 TB/s)."""
    return cells * (13 * 4 + CELL_FINALIZE_OUT_BYTES + CELL_FINALIZE_COPY_BYTES) + 4


def rounds_cost(bins: torch.Tensor, config) -> int:
    """K2: 9 bytes a cell in (bins, mse, edges), round_map, seeds and
    nr_rounds out."""
    B, gh, gw = bins.shape
    return B * gh * gw * (4 + 4 + 1 + 4) + B * config.max_region_growing_rounds * 4 + B * 4


def round_cost(round_map: torch.Tensor, config) -> int:
    """Round finalize: per cell its round, coordinate sum, mean and six
    scatter entries read; seeds, round counts and nr_pts read; the sums rows
    (64 bytes a round), cell labels, plane counts and slot tables (88 bytes
    a slot) written."""
    B = round_map.shape[0]
    R, M = config.max_region_growing_rounds, config.max_planes
    return (round_map.numel() * (4 + 12 + 12 + 24) + B * (R * 4 + 4) + 4
            + B * R * 64 + round_map.numel() * 4 + B * 4 + B * M * 88)


def merge_cost(labels_map: torch.Tensor, segments) -> int:
    """K3: the int32 cell labels, plane counts and the six tables in; merge
    labels and the six tables out."""
    B, M = segments.n.shape
    tables = sum(getattr(segments, f).numel() for f in _TABLES) * 4
    return labels_map.numel() * 4 + B * 4 + 2 * tables + B * M * 4


def labels_cost(labels_map: torch.Tensor, merge_labels: torch.Tensor, image_height: int,
                image_width: int, P: int, dtype: torch.dtype, best_k=None) -> int:
    """Stage 5: the cell and merge labels in, the (B, H*W) labels out in
    `dtype`; with stage 6 (best_k given) also the winners' indices and rows
    (16 bytes a plane) and the points of the labelled pixels."""
    B = labels_map.shape[0]
    n = 4 * (labels_map.numel() + merge_labels.numel())
    n += B * image_height * image_width * torch.empty((), dtype=dtype).element_size()
    if best_k is not None:
        labelled = rasterize_labels(labels_map, merge_labels, image_height, image_width, P) > 0
        n += 12 * int(labelled.sum()) + (8 + 16) * best_k.numel()
    return n


def sampling_cost(rec: Record, image_width: int, P: int, config) -> int:
    """Stage 6's sampling: the cell and merge labels and the raw draws read
    once, the points of the distinct pixels the draws reach in each frame,
    and every output written once."""
    s = rec.sampled
    B, gh, gw = rec.labels_map.shape
    pix = sample_pixels(s.cell_order, s.bounds, s.counts, gw, image_width, P, config,
                        raw=rec.raw)
    distinct = sum(int(torch.unique(pix[b]).numel()) for b in range(B))
    n = 4 * rec.labels_map.numel() + 4 * rec.merge_labels.numel()
    n += 8 * rec.raw.numel() + 12 * distinct
    n += sum(t.numel() * t.element_size() for t in (
        s.cells, s.cell_order, s.bounds, s.counts, s.hyp, *s.state))
    return n


def chunk_cost(rec: Record, done: torch.Tensor, P: int) -> tuple[int, int]:
    """One chunk step: only the frames not done score, and only their
    labelled cells: each such pixel's 12 bytes read once and 6 operations
    (3 multiplies, 3 adds) a hypothesis of the chunk; the cell labels and
    order, the chunk's hypotheses (16 bytes each) and the state read, the
    state written."""
    s = rec.sampled
    cells, Kc = s.cells, s.chunk
    B, gh, gw = cells.shape
    MAXP = s.hyp.shape[1]
    scored = (cells >= 1) & (cells <= MAXP) & ~done.to(cells.device)[:, None, None]
    pixels = int(scored.sum()) * P * P
    state = B * MAXP * (4 + 4 + 1 + 4 + 4 + 8) + B * (1 + 4)
    nbytes = (pixels * 12 + B * gh * gw * (4 + 8) + B * (MAXP + 2) * 8
              + B * MAXP * Kc * 16 + 2 * state)
    return nbytes, pixels * Kc * 6


def call_least_s(rec: Record, config, dtype: torch.dtype) -> dict:
    """Each configured stage's least seconds for the batch `rec` recorded:
    stages 1-5, and stage 6 where configured (its sampling, every chunk
    step the program runs, the labels pass with the final inlier test in
    place of stage 5's)."""
    B, H, W = rec.depth.shape
    P = patch_size(H, W, config)
    out = {"cell_moments": least_s(*moments_cost(rec.depth, config)),
           "cell_finalize": least_s(cells_cost(rec.planes[0].numel())),
           "grow_rounds": least_s(rounds_cost(rec.bins, config)),
           "round_finalize": least_s(round_cost(rec.round_map, config)),
           "merge_planes": least_s(merge_cost(rec.labels_map, rec.segments))}
    if not config.ransac_refinement:
        out["pixel_labels"] = least_s(labels_cost(rec.labels_map, rec.merge_labels, H, W, P,
                                                  dtype))
        return out
    out["ransac_sampling"] = least_s(sampling_cost(rec, W, P, config))
    # The program runs every chunk; a chunk after every frame is done
    # scores nothing (the state as the last recorded chunk left it).
    done = rec.done_before + [rec.sampled.state.done] * (
        rec.sampled.chunks - len(rec.done_before))
    out["ransac_scores"] = sum(least_s(*chunk_cost(rec, d, P)) for d in done)
    out["pixel_labels"] = least_s(labels_cost(rec.labels_map, rec.merge_labels, H, W, P, dtype,
                                              rec.best_k))
    return out
