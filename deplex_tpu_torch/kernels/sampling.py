"""Wrapper of the stage-6 sampling kernel (csrc/sampling.cu): the merged cell
labels, a stable order of the cells by plane, every plane's three-point
hypotheses (fitted, sanitized, padded) and the early-exit loop's first
state, in one launch.

Replaces the XLA fusions of deplex_tpu/ops/ransac.py:105-135 (cell-grid
sampling) and :173-189 (pad_hyp) inside refine_labels (the JAX package has
no pallas_call for them). For CUDA tensors it launches the kernel (or
raises); for CPU tensors it runs the plain twin
``ops.ransac.sample_stage_reference``.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.ransac import (ChunkState, Sampling, chunk_plan, default_draws,
                                         sample_stage_reference)

launches = 0

# The shared memory a block may take on the H100 (227 KB); a block holds its
# frame's order of G cells and its merged ids (6 bytes a cell), the ids'
# first positions, the LUT and each of its 16 warps' counts by id.
MAX_SHARED_BYTES = 232448
WARPS = 16


def shared_bytes(cells: int, max_planes: int) -> int:
    """The kernel's shared memory a block for G = `cells` cells and MAXP
    planes (``shared_bytes`` in csrc/sampling.cu)."""
    ints = (max_planes + 2) + (max_planes + 1) + WARPS * (max_planes + 1) + cells
    return (4 * ints + 2 * cells + 15) // 16 * 16


def check_inputs(points: torch.Tensor, labels_map: torch.Tensor,
                 merge_labels: torch.Tensor | None, image_width: int, patch_size: int,
                 config: Config) -> int:
    """Raise ValueError unless the kernel takes these inputs: (B, gh, gw)
    int32 cell labels, (B, MAXP) int32 merge labels (or None), (B, H*W, 3)
    float32 points of which gh*P x gw*P is a crop, all contiguous on one
    device, and a grid whose sort fits a block's shared memory (G up to
    ~37,000 cells at MAXP 64); returns the image height."""
    MAXP, P, W = config.max_planes, patch_size, image_width
    if labels_map.dim() != 3 or labels_map.dtype != torch.int32 or \
            not labels_map.is_contiguous():
        raise ValueError(f"sample: labels_map must be a contiguous (B, gh, gw) int32 tensor, "
                         f"got {tuple(labels_map.shape)} {labels_map.dtype}")
    B, gh, gw = labels_map.shape
    dev = labels_map.device
    if merge_labels is not None and (
            tuple(merge_labels.shape) != (B, MAXP) or merge_labels.dtype != torch.int32 or
            merge_labels.device != dev or not merge_labels.is_contiguous()):
        raise ValueError(f"sample: merge_labels must be a contiguous ({B}, {MAXP}) int32 "
                         f"tensor on {dev}, got {tuple(merge_labels.shape)} "
                         f"{merge_labels.dtype} on {merge_labels.device}")
    if points.dim() != 3 or points.shape[0] != B or points.shape[2] != 3 or \
            points.dtype != torch.float32 or points.device != dev or \
            not points.is_contiguous():
        raise ValueError(f"sample: points must be a contiguous ({B}, H*W, 3) float32 tensor "
                         f"on {dev}, got {tuple(points.shape)} {points.dtype} on "
                         f"{points.device}")
    H = points.shape[1] // max(W, 1)
    if P < 1 or W < 1 or points.shape[1] != H * W or gh * P > H or gw * P > W or gh * gw == 0:
        raise ValueError(f"sample: {gh}x{gw} cells of {P} are not a crop of {B} frames of "
                         f"{points.shape[1]} points and width {W}")
    need = shared_bytes(gh * gw, MAXP)
    if need > MAX_SHARED_BYTES or B > 65535 or MAXP > 65535:
        raise ValueError(f"sample: {gh}x{gw} cells and {MAXP} planes take {need} bytes of "
                         f"shared memory a block, over the {MAX_SHARED_BYTES} it may hold "
                         f"(or {B} frames, over 65,535)")
    return H


def draws_input(draws: torch.Tensor | None, raw: torch.Tensor | None, B: int, config: Config,
                dev: torch.device):
    """What the kernel reads its ranks from: (int64 tensor on `dev`, whether
    it has a frame axis, whether it holds raw numbers). draws: the
    caller's (MAXP, K, 3) or (B, MAXP, K, 3) ranks, else raw: the (MAXP, K,
    3) int64 raw numbers (``ops.ransac.default_draws`` when None)."""
    shape = (config.max_planes, config.ransac_max_iterations, 3)
    if draws is None:
        u = default_draws(config, dev) if raw is None else raw
        if tuple(u.shape) != shape or u.dtype != torch.int64 or u.device != dev \
                or not u.is_contiguous():
            raise ValueError(f"sample: raw must be a contiguous {shape} int64 tensor on {dev}, "
                             f"got {tuple(u.shape)} {u.dtype} on {u.device}")
        return u, False, True
    u = draws.to(dev, torch.int64)
    if u.dim() == 4 and u.shape[0] == 1:
        u = u[0]
    if tuple(u.shape) not in (shape, (B, *shape)):
        raise ValueError(f"sample: draws must be {shape} or ({B}, {', '.join(map(str, shape))})"
                         f", got {tuple(draws.shape)}")
    return u.contiguous(), u.dim() == 4, False


def outputs(B: int, gh: int, gw: int, config: Config, chunk_size: int | None,
            dev: torch.device) -> Sampling:
    """The kernel's outputs, allocated (it writes every element)."""
    MAXP = config.max_planes
    Kc, S = chunk_plan(config.ransac_max_iterations, chunk_size)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    plane = (B, MAXP)
    state = ChunkState(
        n_pts=empty(plane, torch.float32), target=empty(plane, torch.float32),
        reached=empty(plane, torch.bool), run_best=empty(plane, torch.float32),
        best_loss=empty(plane, torch.float32), best_k=empty(plane, torch.int64),
        done=empty((B,), torch.bool), scored=empty((B,), torch.int32),
        counts=empty((B, MAXP, Kc), torch.int32), tickets=empty((B,), torch.int32))
    return Sampling(empty((B, gh, gw), torch.int32), empty((B, MAXP, S * Kc, 4), torch.float32),
                    empty(plane, torch.int64), empty((B, gh * gw), torch.int64),
                    empty((B, MAXP + 2), torch.int64), state, Kc, S)


def launch(lib, points: torch.Tensor, labels_map: torch.Tensor,
           merge_labels: torch.Tensor | None, ranks, image_height: int, image_width: int,
           patch_size: int, config: Config, out: Sampling) -> int:
    """One launch through the C entry on checked inputs (``check_inputs``,
    ``draws_input``'s `ranks`) into `out` (``outputs``); returns its CUDA
    error code. Counts nothing: ``sample`` counts the path's launches."""
    u, batched, raw = ranks
    B, gh, gw = labels_map.shape
    dev = points.device
    with torch.cuda.device(dev):
        return lib.dplx_ransac_sample(
            labels_map.data_ptr(), None if merge_labels is None else merge_labels.data_ptr(),
            points.data_ptr(), u.data_ptr(), int(raw), int(batched), B, image_height,
            image_width, gh, gw, patch_size, config.max_planes, config.ransac_max_iterations,
            out.hyp.shape[2], out.chunk, float(config.ransac_inliers_ratio),
            out.cells.data_ptr(), out.cell_order.data_ptr(), out.bounds.data_ptr(),
            out.counts.data_ptr(), out.hyp.data_ptr(), *(t.data_ptr() for t in out.state),
            torch.cuda.current_stream(dev).cuda_stream)


def sample(points: torch.Tensor, labels_map: torch.Tensor, merge_labels: torch.Tensor | None,
           image_width: int, patch_size: int, config: Config, *,
           draws: torch.Tensor | None = None, raw: torch.Tensor | None = None,
           chunk_size: int | None = None) -> Sampling:
    """Stage 6's sampling (the contract of
    ``ops.ransac.sample_stage_reference``): (B, H*W, 3) float32 points,
    round finalize's (B, gh, gw) int32 cell labels and K3's (B, MAXP) int32
    merge labels (None: the labels are merged already) -> ``Sampling``.
    draws: (MAXP, K, 3) or (B, MAXP, K, 3) ranks; raw: the default stream's
    (MAXP, K, 3) int64 raw numbers (``ops.ransac.default_draws`` when
    None)."""
    global launches
    H = check_inputs(points, labels_map, merge_labels, image_width, patch_size, config)
    dev = points.device
    if dev.type == "cpu":
        return sample_stage_reference(points, labels_map, merge_labels, image_width,
                                      patch_size, config, draws=draws, raw=raw,
                                      chunk_size=chunk_size)
    if dev.type != "cuda":
        raise ValueError(f"sample: unsupported device {dev}")
    B, gh, gw = labels_map.shape
    ranks = draws_input(draws, raw, B, config, dev)
    out = outputs(B, gh, gw, config, chunk_size, dev)
    _build.check(launch(_build.library(), points, labels_map, merge_labels, ranks, H,
                        image_width, patch_size, config, out), "sample")
    launches += 1
    return out
