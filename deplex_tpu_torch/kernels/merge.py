"""Wrapper of the stage-4 kernel (csrc/merge.cu): plane adjacency and the
greedy plane merge in one launch.

Replaces deplex_tpu/ops/pallas_merge.py:_merge_kernel and the XLA adjacency
it is fed. For CUDA tensors it launches the kernel (or raises); for CPU
tensors it runs the plain twin ``ops.merge.merge_planes_from_labels``.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.growing import PlaneSegments
from deplex_tpu_torch.ops.merge import merge_planes_from_labels as merge_planes_reference

launches = 0

MAX_SLOTS = 1024   # the block version: one thread per plane slot in one block

# The tables the kernel reads and writes, with their trailing shapes.
TABLES = {"n": (), "coord_sum": (3,), "scatter": (3, 3), "normal": (3,), "mean": (3,),
          "d": ()}


def check_inputs(labels_map: torch.Tensor, segments: PlaneSegments, config: Config) -> None:
    """Raise ValueError unless the inputs are what the kernel takes: (B, gh,
    gw) int32 labels, (B,) int32 plane counts and (B, max_planes, ...)
    float32 tables, all on one device."""
    if labels_map.dim() != 3 or labels_map.dtype != torch.int32:
        raise ValueError(f"merge_planes: labels_map must be (B, gh, gw) int32, got "
                         f"{tuple(labels_map.shape)} {labels_map.dtype}")
    B, M, dev = labels_map.shape[0], config.max_planes, labels_map.device
    if not 0 < M <= MAX_SLOTS:
        raise ValueError(f"merge_planes: max_planes {M} is not in 1..{MAX_SLOTS}")
    nr = segments.nr_planes
    if nr.shape != (B,) or nr.dtype != torch.int32 or nr.device != dev:
        raise ValueError(f"merge_planes: segments.nr_planes must be ({B},) int32 on {dev}, "
                         f"got {tuple(nr.shape)} {nr.dtype} on {nr.device}")
    for name, tail in TABLES.items():
        t = getattr(segments, name)
        shape = (B, M, *tail)
        if t.shape != shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"merge_planes: segments.{name} must be {shape} float32 "
                             f"on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def merge_planes(labels_map: torch.Tensor, segments: PlaneSegments, config: Config):
    """(B, gh, gw) int32 cell labels + batched PlaneSegments ->
    (merge_labels (B, MAXP) int32, merged PlaneSegments)."""
    global launches
    check_inputs(labels_map, segments, config)
    dev = labels_map.device
    if dev.type == "cpu":
        return merge_planes_reference(labels_map, segments, config)
    if dev.type != "cuda":
        raise ValueError(f"merge_planes: unsupported device {dev}")
    B, gh, gw = labels_map.shape
    M = config.max_planes
    labels = labels_map.contiguous()
    ins = [getattr(segments, name).contiguous() for name in TABLES]
    outs = [torch.empty_like(t) for t in ins]
    merge_labels = torch.empty((B, M), dtype=torch.int32, device=dev)
    rc = _build.library().dplx_merge_from_labels(
        labels.data_ptr(), segments.nr_planes.data_ptr(),
        *(t.data_ptr() for t in ins), B, gh, gw, M,
        float(config.min_cos_angle_merge), float(config.max_merge_dist),
        merge_labels.data_ptr(), *(t.data_ptr() for t in outs), None,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "merge_planes")
    launches += 1
    return merge_labels, segments._replace(**dict(zip(TABLES, outs)))
