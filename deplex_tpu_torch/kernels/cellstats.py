"""Wrapper of the stage-1 kernel (csrc/cellstats.cu): per-cell moments.

Replaces deplex_tpu/ops/pallas_cellstats.py:_kernel. For CUDA tensors it
launches the kernel (or raises); for CPU tensors it runs the plain twin
``ops.cellstats.cell_moments_reference``.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.cellstats import (CellMoments, cell_moments_reference,
                                            moments_band_plan_exists,
                                            moments_from_planes, patch_size)

launches = 0


def cell_moments(src: torch.Tensor, K: torch.Tensor | None, config: Config) -> CellMoments:
    """(B, H, W) uint16 depth + 3x3 K, or (B, H, W, 3) float32 points with
    K None -> CellMoments with (B, H // P, W // P) planes."""
    global launches
    if src.device.type == "cpu":
        return cell_moments_reference(src, K, config)
    if src.device.type != "cuda":
        raise ValueError(f"cell_moments: unsupported device {src.device}")
    if not src.is_contiguous():
        raise ValueError("cell_moments: input must be contiguous")
    is_points = src.dim() == 4
    if is_points:
        if src.shape[3] != 3 or src.dtype != torch.float32 or K is not None:
            raise ValueError("cell_moments: points must be (B, H, W, 3) float32 "
                             f"with K None, got {tuple(src.shape)} {src.dtype}")
    elif src.dim() != 3 or src.dtype != torch.uint16 or K is None:
        raise ValueError("cell_moments: depth must be (B, H, W) uint16 with a 3x3 K, "
                         f"got {tuple(src.shape)} {src.dtype}")
    B, H, W = src.shape[:3]
    P = patch_size(H, W, config)
    if P < 1:
        raise ValueError(f"cell_moments: patch size {P} for a {H}x{W} frame")
    gh, gw = H // P, W // P
    anchored = int(moments_band_plan_exists(gh, P, gw * P))
    thr = float(config.depth_discontinuity_threshold)
    out = torch.empty((13, B, gh, gw), dtype=torch.float32, device=src.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    if is_points:
        rc = lib.dplx_cell_moments_points(src.data_ptr(), B, H, W, P, thr, anchored,
                                          out.data_ptr(), stream)
    else:
        k = [float(v) for v in torch.as_tensor(K, dtype=torch.float32).cpu().reshape(9)]
        rc = lib.dplx_cell_moments_depth(src.data_ptr(), B, H, W, P, k[0], k[4], k[2],
                                         k[5], thr, anchored, out.data_ptr(), stream)
    _build.check(rc, "cell_moments")
    launches += 1
    return moments_from_planes(out)
