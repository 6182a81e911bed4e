"""The plane-extraction pipeline: depth or points -> per-pixel plane labels.

Port of ``deplex_tpu.pipeline``. Five stages, batched over frames:
  1. cell statistics      (kernel: csrc/cellstats.cu)
  2. normal bins, edges   (plain ops)
  3. region growing       (kernel: csrc/growing.cu) + region_sums, finalize
  4. adjacency + merge    (kernel: csrc/merge.cu, one launch)
  5. rasterize to pixels  (plain ops)
  6. RANSAC refinement    (plain ops, ops/ransac.py; config.ransac_refinement)
The stages call the kernel wrappers of ``kernels/``, which run the kernel
for tensors on the card and the plain twin of ``ops/`` for tensors on the
CPU. On the card the path runs in float32 with TF32 off, and nothing
between the upload and the label download waits for the device.
"""

from __future__ import annotations

import numpy as np
import torch

from deplex_tpu_torch import kernels
from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.cellstats import CellStats, finalize_cell_stats, patch_size
from deplex_tpu_torch.ops.growing import PlaneSegments, finalize_rounds
from deplex_tpu_torch.ops.merge import apply_label_lut, rasterize_labels
from deplex_tpu_torch.ops.ransac import refine_batch


def resolve_device(device=None) -> torch.device:
    """An entry point's ``device`` argument: the given one, else the card.
    Raises when none is given and there is no card: the plain twins run on
    the CPU only when the caller asks for them with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("deplex_tpu_torch: no CUDA device (torch.cuda.is_available() "
                           "is False); pass device=\"cpu\" to run the plain PyTorch "
                           "twins on the CPU")
    return torch.device("cuda")


def use_full_float32(device: torch.device) -> None:
    """Turn TF32 off for matrix products on the card (region_sums is one)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def depth_tensor(depth, device) -> torch.Tensor:
    """uint16 depth (numpy or tensor) -> a uint16 tensor on `device`.

    The transfer goes through an int16 view of the same bytes, since uint16
    tensors support few operations."""
    if isinstance(depth, torch.Tensor):
        if depth.dtype != torch.uint16:
            raise ValueError(f"depth must be uint16, got {depth.dtype}")
        return depth.view(torch.int16).to(device).view(torch.uint16)
    arr = np.ascontiguousarray(depth)
    if arr.dtype != np.uint16:
        raise ValueError(f"depth must be uint16, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.uint16)


def intrinsics_tensor(K) -> torch.Tensor:
    """3x3 intrinsics as a float32 tensor on the host; the kernels take its
    entries as launch arguments, so it never waits on the card."""
    if isinstance(K, torch.Tensor):
        return K.detach().to(device="cpu", dtype=torch.float32).reshape(3, 3)
    return torch.as_tensor(np.asarray(K, np.float32).reshape(3, 3))


def backproject_device(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., H, W) depth -> (..., H*W, 3) float32 organized clouds on depth's
    device: x = (u - cx) / fx * z, y = (v - cy) / fy * z."""
    H, W = depth.shape[-2:]
    K = intrinsics.to(device=depth.device, dtype=torch.float32)
    fx, cx, fy, cy = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    if depth.dtype == torch.uint16:
        depth = depth.view(torch.int16).to(torch.int32) & 0xFFFF
    z = depth.to(torch.float32)
    u = (torch.arange(W, dtype=torch.float32, device=depth.device)[None, :] - cx) / fx
    v = (torch.arange(H, dtype=torch.float32, device=depth.device)[:, None] - cy) / fy
    return torch.stack([u * z, v * z, z], dim=-1).reshape(*depth.shape[:-2], H * W, 3)


def compute_cell_stats(src: torch.Tensor, K: torch.Tensor | None,
                       config: Config) -> CellStats:
    """Stage 1 for a batch: (B, H, W) depth + K, or (B, H, W, 3) points;
    the moments kernel, then the eigensolve and gates."""
    H, W = src.shape[1], src.shape[2]
    return finalize_cell_stats(kernels.cellstats.cell_moments(src, K, config),
                               patch_size(H, W, config), config)


def grow_planes(stats: CellStats, config: Config):
    """Stage 3: the rounds-loop kernel and the finalize pass.
    Returns (labels_map, PlaneSegments)."""
    return finalize_rounds(kernels.growing.grow_rounds(stats, config), config)


def merge_planes(labels_map: torch.Tensor, segments: PlaneSegments, config: Config):
    """Stage 4: the adjacency and the greedy merge, one kernel launch.
    Returns (merge_labels, merged PlaneSegments)."""
    return kernels.merge.merge_planes(labels_map, segments, config)


def merge_stage(labels_map: torch.Tensor, segments, config: Config) -> torch.Tensor:
    """Stage 4: (B, gh, gw) labels + PlaneSegments -> (B, MAXP) merge_labels."""
    merge_labels, _ = merge_planes(labels_map, segments, config)
    return merge_labels


def labels_from_stats(stats, image_height: int, image_width: int,
                      config: Config, points: torch.Tensor | None = None) -> torch.Tensor:
    """Stages 2-5 for a batch: CellStats -> (B, H*W) int32 labels; with
    config.ransac_refinement also stage 6, on the (B, H*W, 3) points."""
    labels_map, segments = grow_planes(stats, config)
    merge_labels = merge_stage(labels_map, segments, config)
    P = patch_size(image_height, image_width, config)
    labels = rasterize_labels(labels_map, merge_labels, image_height, image_width, P)
    if not config.ransac_refinement:
        return labels
    return refine_batch(points, labels, apply_label_lut(labels_map, merge_labels),
                        image_width, P, config)


def check_patch(image_height: int, image_width: int, config: Config) -> None:
    """Raise the reference's error for a cell side of 0."""
    if patch_size(image_height, image_width, config) == 0:
        raise ValueError(
            f"Error! Invalid config parameter: patchSize({config.patch_size})."
            " patchSize has to be positive.")


def extract_planes(points: torch.Tensor, *, image_height: int, image_width: int,
                   config: Config) -> torch.Tensor:
    """points: (H*W, 3) organized cloud -> (H*W,) int32 labels (0 = none)."""
    check_patch(image_height, image_width, config)
    use_full_float32(points.device)
    pts = points.to(torch.float32).reshape(1, image_height, image_width, 3).contiguous()
    stats = compute_cell_stats(pts, None, config)
    return labels_from_stats(stats, image_height, image_width, config,
                             pts.reshape(1, -1, 3))[0]


def extract_planes_from_depth(depth: torch.Tensor, intrinsics, *,
                              config: Config) -> torch.Tensor:
    """(H, W) uint16 depth + 3x3 intrinsics -> (H*W,) int32 labels.

    Stage 1 reads the depth map itself; the point cloud is never formed."""
    from deplex_tpu_torch.parallel.batch import extract_depth_batch

    return extract_depth_batch(depth[None], intrinsics, config)[0]


def _unbatch(x):
    """First frame of a batched NamedTuple (0-d fields kept)."""
    return type(x)(*[f[0] if f.dim() > 0 else f for f in x])


def extract_planes_debug(points: torch.Tensor, *, image_height: int,
                         image_width: int, config: Config) -> dict:
    """Single-frame pipeline returning its intermediates, with the keys of
    the reference package's extract_planes_debug (stages 1-5)."""
    check_patch(image_height, image_width, config)
    use_full_float32(points.device)
    pts = points.to(torch.float32).reshape(1, image_height, image_width, 3).contiguous()
    stats = compute_cell_stats(pts, None, config)
    labels_map, segments = grow_planes(stats, config)
    merge_labels, merged = merge_planes(labels_map, segments, config)
    P = patch_size(image_height, image_width, config)
    labels = rasterize_labels(labels_map, merge_labels, image_height, image_width, P)
    return {"stats": _unbatch(stats), "labels_map": labels_map[0],
            "segments": _unbatch(segments), "merge_labels": merge_labels[0],
            "merged": _unbatch(merged), "labels": labels[0]}
