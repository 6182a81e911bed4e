"""Spatial sharding: ONE frame's cell grid split by rows across ranks.

Port of ``deplex_tpu.parallel.spatial`` (for a frame large enough that its
latency matters more than batch throughput, e.g. 1280x720) with another
design. The reference shards every stage and runs per-round collectives
inside the region-growing loop; here the growing loop is one warp's work in
a kernel (K2), which no collective can enter. So:

  1. the cell rows are split over the ranks of a 1-D mesh axis, padded to a
     multiple of the axis size with zero rows (no valid point: non-planar);
  2. each rank computes the cell moments of its row block (K1's points
     entry, per cell, so the block's cells are the single-process cells
     bit for bit);
  3. the moments are gathered (K1's 13 floats a cell, one ``all_gather``)
     and cut back to the frame's real cell rows: the adjacency of stage 4
     leaves out the grid's last row, which pad rows would turn into an
     inner row;
  4. the cell-finalize kernel (the fit, gates, bins and edges: an edge
     reads its neighbours, across the blocks' seams too) and stages 3-5
     (K2, round finalize, K3, the rasterization) run replicated on every
     rank, which then holds the whole frame's labels: no second collective.

No float crosses a rank boundary in a sum, so every rank's labels equal one
process's exactly (the reference agrees with its single-device path to
>= 0.99 of the pixels).
"""

from __future__ import annotations

import torch

from deplex_tpu_torch import kernels
from deplex_tpu_torch.config import Config
from deplex_tpu_torch.parallel.distributed import all_gather_cat
from deplex_tpu_torch.pipeline import (check_patch, full_float32, patch_size, resolve_device,
                                       stages_3_4, write_labels)
from deplex_tpu_torch.profiling import annotate

# The floats a cell in the gathered table: K1's moment planes.
CELL_FLOATS = 13


def extract_planes_spatial(points, *, image_height: int, image_width: int,
                           config: Config, mesh, axis: str = "space",
                           device=None) -> torch.Tensor:
    """Single-frame extraction with the cell grid row-sharded over mesh[axis].

    points: the whole (H*W, 3) organized cloud, on every rank -> the whole
    (H*W,) int32 labels on every rank, equal to ``pipeline.extract_planes``'s,
    on `device` (default: the card, raising without one; ``"cpu"`` for the
    twins). RANSAC refinement is a global per-plane pass and is refused (use
    the data-parallel path)."""
    H, W = image_height, image_width
    ntp = mesh.size(mesh.mesh_dim_names.index(axis))
    check_patch(H, W, config)
    if config.ransac_refinement:
        raise ValueError("spatial sharding does not support ransac_refinement;"
                         " use the data-parallel path (parallel/batch.py)")
    P = patch_size(H, W, config)
    gh0 = H // P
    if gh0 < ntp:
        raise ValueError(f"grid has {gh0} cell rows < {ntp} shards on "
                         f"mesh axis '{axis}'")
    dev = resolve_device(device)
    group = mesh.get_group(axis)
    rank = mesh.get_local_rank(axis)
    per = -(-gh0 // ntp)                        # cell rows a rank, pad rows included
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev).reshape(H, W, 3)
    # This rank's rows of the zero-padded image (rows past gh0 * P are pad).
    r0, r1 = rank * per * P, (rank + 1) * per * P
    block = torch.zeros((1, per * P, W, 3), dtype=torch.float32, device=dev)
    real = max(0, min(r1, gh0 * P) - r0)
    block[0, :real] = pts[r0:r0 + real]
    with full_float32(dev):
        with annotate("cell_grid"):
            local = kernels.cellstats.cell_moment_planes(block, None, config)   # (13, 1, per, gw)
        with annotate("gather_cell_stats"):
            table = all_gather_cat(local[:, 0].permute(1, 2, 0).contiguous(), group)[:gh0]
        with annotate("cell_grid"):
            cells = kernels.cellfinal.cell_finalize(
                table.permute(2, 0, 1)[:, None].contiguous(), P, config)
        return write_labels(stages_3_4(cells, config), H, W, config)[0]
