"""Wrapper of the stage-6 chunk-step kernel (csrc/ransac.cu): one chunk of
RANSAC hypotheses scored and the reference's early-exit update applied, in
one launch.

Replaces the XLA fusion of deplex_tpu/ops/ransac.py:chunk_losses and the
body of refine_labels' while_loop around it (the JAX package has no
pallas_call for them). For CUDA tensors it launches the kernel (or raises);
for CPU tensors it runs the plain twin ``ops.ransac.chunk_step_reference``.
A launch counts as one whether or not its guard skips every frame;
``state.scored`` says which frames a launch scored.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.ransac import ChunkState, chunk_step_reference

launches = 0

# The pixels a block scores: a run of that many pixels' worth of cells in
# plane order (at least one cell), chosen on the card among 512-4096 at TUM
# (PERF.md). The kernel stages at most TILE_PIXELS of them at a time.
RUN_PIXELS = 1536
TILE_PIXELS = 1536
MAX_CHUNK = 256          # hypotheses a chunk: 8 a lane at most


def run_cells(patch_size: int) -> int:
    """Cells a block scores at cell side `patch_size`, from P alone."""
    return max(1, RUN_PIXELS // (patch_size * patch_size))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple | None,
           dev: torch.device) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != shape):
        raise ValueError(f"chunk_step: {name} must be a contiguous {dtype} "
                         f"{shape or '(B, H*W, 3)'} on {dev}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def check_inputs(points: torch.Tensor, cell_labels: torch.Tensor, hyp: torch.Tensor,
                 cell_order: torch.Tensor, bounds: torch.Tensor, state: ChunkState, *,
                 s: int, chunk: int, image_width: int, patch_size: int,
                 losses: torch.Tensor | None = None) -> int:
    """Raise unless the kernel takes these tensors (device, dtype, shape,
    contiguity of each); returns the image height."""
    dev = points.device
    B, gh, gw = cell_labels.shape
    MAXP, n_hyp = hyp.shape[1:3]
    P, W, G = patch_size, image_width, gh * gw
    plane, frame = (B, MAXP), (B,)
    for name, t, dtype, shape in (
            ("points", points, torch.float32, None),
            ("cell_labels", cell_labels, torch.int32, (B, gh, gw)),
            ("hyp", hyp, torch.float32, (B, MAXP, n_hyp, 4)),
            ("cell_order", cell_order, torch.int64, (B, G)),
            ("bounds", bounds, torch.int64, (B, MAXP + 2)),
            ("state.n_pts", state.n_pts, torch.float32, plane),
            ("state.target", state.target, torch.float32, plane),
            ("state.reached", state.reached, torch.bool, plane),
            ("state.run_best", state.run_best, torch.float32, plane),
            ("state.best_loss", state.best_loss, torch.float32, plane),
            ("state.best_k", state.best_k, torch.int64, plane),
            ("state.done", state.done, torch.bool, frame),
            ("state.scored", state.scored, torch.int32, frame),
            ("state.counts", state.counts, torch.int32, (B, MAXP, chunk)),
            ("state.tickets", state.tickets, torch.int32, frame)) + (
            () if losses is None else (("losses", losses, torch.int32, (B, MAXP, chunk)),)):
        _check(name, t, dtype, shape, dev)
    H = points.numel() // max(B * W * 3, 1)
    if points.numel() != B * H * W * 3 or gh * P > H or gw * P > W or not 1 <= P <= TILE_PIXELS:
        raise ValueError(f"chunk_step: points {tuple(points.shape)} are not {B} frames "
                         f"of width {W} holding {gh}x{gw} cells of {P}")
    if not (0 < chunk <= MAX_CHUNK and 0 <= s and (s + 1) * chunk <= n_hyp) or B > 65535:
        raise ValueError(f"chunk_step: chunk {s} of {chunk} (at most {MAX_CHUNK}) outside "
                         f"{n_hyp} hypotheses, or {B} frames")
    return H


def chunk_step(points: torch.Tensor, cell_labels: torch.Tensor, hyp: torch.Tensor,
               cell_order: torch.Tensor, bounds: torch.Tensor, state: ChunkState, *, s: int,
               chunk: int, threshold: float, image_width: int, patch_size: int,
               losses: torch.Tensor | None = None) -> None:
    """Chunk s scored and the early-exit update applied to `state` in place
    (the contract of ``ops.ransac.chunk_step_reference``)."""
    global launches
    if points.device.type == "cpu":
        chunk_step_reference(points, cell_labels, hyp, cell_order, bounds, state, s=s,
                             chunk=chunk, threshold=threshold, image_width=image_width,
                             patch_size=patch_size, losses=losses)
        return
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"chunk_step: unsupported device {dev}")
    H = check_inputs(points, cell_labels, hyp, cell_order, bounds, state, s=s, chunk=chunk,
                     image_width=image_width, patch_size=patch_size, losses=losses)
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = launch(lib, points, cell_labels, hyp, cell_order, bounds, state, s, chunk,
                    threshold, H, image_width, patch_size, run_cells(patch_size),
                    torch.cuda.current_stream(dev).cuda_stream, losses)
    _build.check(rc, "chunk_step")
    launches += 1


def launch(lib, points: torch.Tensor, cell_labels: torch.Tensor, hyp: torch.Tensor,
           cell_order: torch.Tensor, bounds: torch.Tensor, state: ChunkState, s: int,
           chunk: int, threshold: float, image_height: int, image_width: int,
           patch_size: int, run_cells: int, stream: int,
           losses: torch.Tensor | None = None) -> int:
    """One call of the C entry on checked inputs (``check_inputs``; the cell
    labels give the grid's shape): chunk s of `chunk` hypotheses, blocks of
    `run_cells` cells, the state updated in place and the chunk's counts in
    `losses` where given. Returns the CUDA error code."""
    B, gh, gw = cell_labels.shape
    MAXP, n_hyp = hyp.shape[1:3]
    return lib.dplx_ransac_chunk_step(
        points.data_ptr(), hyp.data_ptr(), cell_order.data_ptr(), bounds.data_ptr(),
        *(t.data_ptr() for t in state), None if losses is None else losses.data_ptr(), B,
        image_height, image_width, gh, gw, patch_size, MAXP, n_hyp, s, chunk, run_cells,
        float(threshold), stream)
