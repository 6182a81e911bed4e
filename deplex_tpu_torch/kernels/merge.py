"""Wrapper of the stage-4 kernel (csrc/merge.cu): the greedy plane merge.

Replaces deplex_tpu/ops/pallas_merge.py:_merge_kernel. For CUDA tensors it
launches the kernel (or raises); for CPU tensors it runs the plain twin
``ops.merge.merge_planes_from_adjacency``.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.growing import PlaneSegments
from deplex_tpu_torch.ops.merge import \
    merge_planes_from_adjacency as merge_planes_reference

launches = 0

MAX_SLOTS = 1024   # one thread per plane slot in one block


def merge_planes_from_adjacency(assoc: torch.Tensor, segments: PlaneSegments,
                                config: Config):
    """(B, MAXP, MAXP) bool adjacency + batched PlaneSegments ->
    (merge_labels (B, MAXP) int32, merged PlaneSegments)."""
    global launches
    dev = assoc.device
    if dev.type == "cpu":
        return merge_planes_reference(assoc, segments, config)
    if dev.type != "cuda":
        raise ValueError(f"merge_planes: unsupported device {dev}")
    B, M = segments.n.shape
    if M > MAX_SLOTS:
        raise ValueError(f"merge_planes: max_planes {M} is over {MAX_SLOTS}")
    if assoc.shape != (B, M, M) or assoc.dtype != torch.bool:
        raise ValueError(f"merge_planes: assoc must be ({B}, {M}, {M}) bool, "
                         f"got {tuple(assoc.shape)} {assoc.dtype}")
    shapes = {"n": (B, M), "coord_sum": (B, M, 3), "scatter": (B, M, 3, 3),
              "normal": (B, M, 3), "mean": (B, M, 3), "d": (B, M)}
    inputs = {}
    for name, shape in shapes.items():
        t = getattr(segments, name)
        if t.shape != shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"merge_planes: segments.{name} must be {shape} float32 "
                             f"on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        inputs[name] = t.contiguous()
    nr_planes = segments.nr_planes.to(device=dev, dtype=torch.int32).contiguous()
    assoc_u8 = assoc.to(torch.uint8).contiguous()
    outs = {name: torch.empty(shape, dtype=torch.float32, device=dev)
            for name, shape in shapes.items()}
    merge_labels = torch.empty((B, M), dtype=torch.int32, device=dev)
    rc = _build.library().dplx_merge_planes(
        assoc_u8.data_ptr(), nr_planes.data_ptr(),
        *(inputs[k].data_ptr() for k in shapes), B, M,
        float(config.min_cos_angle_merge), float(config.max_merge_dist),
        merge_labels.data_ptr(), *(outs[k].data_ptr() for k in shapes),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "merge_planes")
    launches += 1
    merged = segments._replace(**outs)
    return merge_labels, merged
