"""Wrapper of the stage-6 scoring kernel (csrc/ransac.cu): per-plane outlier
counts of one chunk of RANSAC hypotheses, with the early exit on the card.

Replaces the XLA fusion of deplex_tpu/ops/ransac.py:chunk_losses (inside
refine_labels' while_loop; the JAX package has no pallas_call for it). For
CUDA tensors it launches the kernel (or raises); for CPU tensors it runs the
plain twin ``ops.ransac.chunk_outliers_reference``. A launch counts as one
whether or not its guard skips every frame; ``scored`` says which frames a
launch scored.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.ransac import chunk_outliers_reference

launches = 0


def chunk_outliers(points: torch.Tensor, cell_labels: torch.Tensor, n_tab: torch.Tensor,
                   d_tab: torch.Tensor, done: torch.Tensor, scored: torch.Tensor, *, s: int,
                   chunk: int, threshold: float, image_width: int,
                   patch_size: int) -> torch.Tensor:
    """(B, MAXP, Kc) int32 outlier counts of hypothesis chunk s, 0 for the
    frames `done` marks; scored[b] += 1 for each other frame (the contract
    of ``ops.ransac.chunk_outliers_reference``)."""
    global launches
    if points.device.type == "cpu":
        return chunk_outliers_reference(points, cell_labels, n_tab, d_tab, done, scored, s=s,
                                        chunk=chunk, threshold=threshold,
                                        image_width=image_width, patch_size=patch_size)
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"chunk_outliers: unsupported device {dev}")
    B, gh, gw = cell_labels.shape
    MAXP, hyp = d_tab.shape[1:]
    P, W = patch_size, image_width
    for name, t, dtype, shape in (
            ("points", points, torch.float32, None), ("cell_labels", cell_labels, torch.int32,
                                                      (B, gh, gw)),
            ("n_tab", n_tab, torch.float32, (B, MAXP, hyp, 3)),
            ("d_tab", d_tab, torch.float32, (B, MAXP, hyp)), ("done", done, torch.bool, (B,)),
            ("scored", scored, torch.int32, (B,))):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"chunk_outliers: {name} must be a contiguous {dtype} "
                             f"{shape or '(B, H*W, 3)'} on {dev}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    H = points.numel() // max(B * W * 3, 1)
    if points.numel() != B * H * W * 3 or gh * P > H or gw * P > W or P < 1:
        raise ValueError(f"chunk_outliers: points {tuple(points.shape)} are not {B} frames "
                         f"of width {W} holding {gh}x{gw} cells of {P}")
    if not (0 < chunk and 0 <= s and (s + 1) * chunk <= hyp) or B > 65535:
        raise ValueError(f"chunk_outliers: chunk {s} of {chunk} outside {hyp} hypotheses, "
                         f"or {B} frames")
    out = torch.zeros((B, MAXP, chunk), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.dplx_ransac_outliers(
            points.data_ptr(), cell_labels.data_ptr(), n_tab.data_ptr(), d_tab.data_ptr(),
            done.data_ptr(), scored.data_ptr(), B, H, W, gh, gw, P, MAXP, hyp, s, chunk,
            float(threshold), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "chunk_outliers")
    launches += 1
    return out
