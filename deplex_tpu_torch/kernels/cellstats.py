"""Wrapper of the stage-1 kernel (csrc/cellstats.cu): per-cell moments.

Replaces deplex_tpu/ops/pallas_cellstats.py:_kernel. For CUDA tensors it
launches the kernel (or raises); for CPU tensors it runs the plain twin
``ops.cellstats.cell_moments_reference``. ``cell_moment_planes`` returns
the kernel's 13 planes as they are, which the cell-finalize kernel reads.
A depth source takes its 3x3 K as a tensor on the depth's card: the kernel
reads fx, fy, cx and cy from there, so a recorded graph serves every
camera.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.cellstats import (CellMoments, camera_params, cell_moments_reference,
                                            moments_band_plan_exists,
                                            moments_from_planes, patch_size,
                                            planes_from_moments)

launches = 0


def check_intrinsics(src: torch.Tensor, K) -> None:
    """Raise unless K is a 3x3 tensor on the depth's device: the kernel
    reads the intrinsics from device memory, and a host K would be a copy
    that no CUDA graph can record."""
    if not isinstance(K, torch.Tensor) or K.device != src.device or K.numel() != 9:
        where = K.device if isinstance(K, torch.Tensor) else type(K).__name__
        raise ValueError(f"cell_moments: K must be a 3x3 tensor on the depth's device "
                         f"{src.device}, got {where}")


def cell_moments(src: torch.Tensor, K: torch.Tensor | None, config: Config) -> CellMoments:
    """(B, H, W) uint16 depth + 3x3 K, or (B, H, W, 3) float32 points with
    K None -> CellMoments with (B, H // P, W // P) planes."""
    if src.device.type == "cpu":
        return cell_moments_reference(src, K, config)
    return moments_from_planes(cell_moment_planes(src, K, config))


def cell_moment_planes(src: torch.Tensor, K: torch.Tensor | None,
                       config: Config) -> torch.Tensor:
    """``cell_moments``' input -> the (13, B, H // P, W // P) float32 planes in
    kernel order (``ops.cellstats.moments_from_planes``)."""
    global launches
    if src.device.type == "cpu":
        return planes_from_moments(cell_moments_reference(src, K, config))
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
    else:
        check_intrinsics(src, K)
    B, H, W = src.shape[:3]
    P = patch_size(H, W, config)
    if P < 1:
        raise ValueError(f"cell_moments: patch size {P} for a {H}x{W} frame")
    gh, gw = H // P, W // P
    anchored = int(moments_band_plan_exists(gh, P, gw * P))
    out = torch.empty((13, B, gh, gw), dtype=torch.float32, device=src.device)
    lib = _build.library()
    # The card of the tensors is made current: the runtime launches there.
    with torch.cuda.device(src.device):
        kparams = None if is_points else camera_params(K)
        rc = launch(lib, src, kparams, config, out, P, anchored,
                    torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(rc, "cell_moments")
    launches += 1
    return out


def launch(lib, src: torch.Tensor, kparams: torch.Tensor | None, config: Config,
           out: torch.Tensor, P: int, anchored: int, stream: int) -> int:
    """One call of a C entry on checked inputs: (B, H, W) uint16 depth with
    its intrinsics on the card (``camera_params``), or (B, H, W, 3) float32
    points with `kparams` None; into `out`, the (13, B, H // P, W // P)
    float32 planes, with the band plan `anchored` (0 or 1). Returns the
    CUDA error code."""
    B, H, W = src.shape[:3]
    thr = float(config.depth_discontinuity_threshold)
    if kparams is None:
        return lib.dplx_cell_moments_points(src.data_ptr(), B, H, W, P, thr, anchored,
                                            out.data_ptr(), stream)
    return lib.dplx_cell_moments_depth(src.data_ptr(), B, H, W, P, kparams.data_ptr(), thr,
                                       anchored, out.data_ptr(), stream)
