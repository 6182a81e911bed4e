"""Depth frames and intrinsics -> pixel labels, stage by stage in plain
PyTorch: the reference the benchmark holds the port's labels to.

Every stage runs in float32 with TF32 off (``full_float32``), on whatever
device the frames are on; the port's card kernels are bit-equal to these
stages by design, so the comparison is exact. ``Record`` keeps what the
benchmark's byte and operation counts read (``benchmark.costs``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from benchmark.reference.cellstats import (camera_params, cell_moments_reference, patch_size,
                                           planes_from_moments)
from benchmark.reference.config import Config
from benchmark.reference.growing import (finalize_cells, finalize_grown, grow_rounds_loop,
                                         unpack_edges)
from benchmark.reference.merge import merge_planes_from_labels, pixel_labels_reference
from benchmark.reference.ransac import (chunk_step_reference, default_draws, refine_cells,
                                        sample_stage_reference, winners)


@dataclasses.dataclass
class Record:
    """What one batch's stages computed, for the byte and operation counts."""
    depth: torch.Tensor | None = None
    planes: torch.Tensor | None = None          # (13, B, gh, gw) moment planes
    bins: torch.Tensor | None = None            # (B, gh, gw) normal bins
    round_map: torch.Tensor | None = None       # (B, gh, gw) rounds
    labels_map: torch.Tensor | None = None      # (B, gh, gw) cell labels
    segments: object = None                     # PlaneSegments before the merge
    merge_labels: torch.Tensor | None = None    # (B, MAXP)
    points: torch.Tensor | None = None          # (B, H*W, 3), stage 6 only
    sampled: object = None                      # stage 6's Sampling
    raw: torch.Tensor | None = None             # the default draws' raw numbers
    done_before: list = dataclasses.field(default_factory=list)  # (B,) bool a chunk
    hyp: torch.Tensor | None = None
    best_k: torch.Tensor | None = None


@contextlib.contextmanager
def full_float32():
    """float32 products without TF32 inside; the flags as they were after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def backproject(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint16 depth -> (B, H*W, 3) float32 points: x = (u - cx) /
    fx * z, y = (v - cy) / fy * z, divided as the kernels divide (by device
    tensors)."""
    H, W = depth.shape[-2:]
    fx, fy, cx, cy = camera_params(K.to(depth.device)).unbind()
    z = (depth.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32)
    u = (torch.arange(W, dtype=torch.float32, device=depth.device)[None, :] - cx) / fx
    v = (torch.arange(H, dtype=torch.float32, device=depth.device)[:, None] - cy) / fy
    return torch.stack([u * z, v * z, z], dim=-1).reshape(*depth.shape[:-2], H * W, 3)


def labels(depth: torch.Tensor, K: torch.Tensor, config: Config,
           dtype: torch.dtype = torch.int32, record: Record | None = None) -> torch.Tensor:
    """(B, H, W) uint16 depth and a 3x3 float32 K -> (B, H*W) labels in
    `dtype` (uint8: the low 8 bits): stages 1-5, and stage 6 with
    config.ransac_refinement (the default draws: raw numbers from a CPU
    generator seeded 0, every frame the same; the early exit checked on the
    host after each chunk)."""
    B, H, W = depth.shape
    P = patch_size(H, W, config)
    rec = record if record is not None else Record()
    with full_float32():
        moments = cell_moments_reference(depth, K, config)
        rec.depth, rec.planes = depth, planes_from_moments(moments)
        cells = finalize_cells(moments, P, config)
        edges, _ = unpack_edges(cells.edges)
        round_map, seeds, nr_rounds = grow_rounds_loop(cells.bins, cells.stats.mse, edges,
                                                       cells.stats.planar, config)
        _, labels_map, segments = finalize_grown(round_map, seeds, nr_rounds, cells.stats,
                                                 config)
        merge_labels, _ = merge_planes_from_labels(labels_map, segments, config)
        rec.bins, rec.round_map, rec.labels_map = cells.bins, round_map, labels_map
        rec.segments, rec.merge_labels = segments, merge_labels
        if not config.ransac_refinement:
            return pixel_labels_reference(labels_map, merge_labels, H, W, P, dtype)
        rec.points = backproject(depth, K)
        rec.raw = default_draws(config, depth.device)

        def sample(*args, **kw):
            rec.sampled = sample_stage_reference(*args, **kw)
            return rec.sampled

        def step(points, cells, hyp, order, bounds, state, **kw):
            rec.done_before.append(state.done.clone())
            chunk_step_reference(points, cells, hyp, order, bounds, state, **kw)

        def write(points, hyp, best_k, threshold):
            rec.hyp, rec.best_k = hyp, best_k
            return pixel_labels_reference(labels_map, merge_labels, H, W, P, dtype,
                                          (points, winners(hyp, best_k), threshold))

        out, _ = refine_cells(rec.points, None, labels_map, W, P, config,
                              merge_labels=merge_labels, sample=sample, step=step,
                              raw=rec.raw, fixed_trip=False, write=write)
        return out
