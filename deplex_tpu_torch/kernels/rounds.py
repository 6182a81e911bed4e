"""Wrapper of the stage-3 epilogue kernel (csrc/rounds.cu): every growing
round's sums in a fixed tree order, its fit and gates, the plane slots, the
cell labels and the slot tables, in one launch.

Replaces the XLA fusions of deplex_tpu/ops/growing.py:region_sums and
:finalize_rounds. For CUDA tensors it launches the kernel (or raises); for
CPU tensors it runs the plain twin ``ops.growing.finalize_grown``.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.cellstats import CellStats
from deplex_tpu_torch.ops.growing import PlaneSegments, RoundData, finalize_grown

launches = 0


def round_finalize(round_map: torch.Tensor, seeds: torch.Tensor, nr_rounds: torch.Tensor,
                   stats: CellStats, config: Config):
    """The growing kernel's round_map (B, gh, gw), seeds (B, R_MAX) and
    nr_rounds (B,), int32, and the cells' CellStats -> (RoundData,
    labels_map (B, gh, gw) int32, PlaneSegments), as ``finalize_grown``."""
    global launches
    dev = round_map.device
    if dev.type == "cpu":
        return finalize_grown(round_map, seeds, nr_rounds, stats, config)
    if dev.type != "cuda":
        raise ValueError(f"round_finalize: unsupported device {dev}")
    B, gh, gw = round_map.shape
    N, R, MAXP = gh * gw, config.max_region_growing_rounds, config.max_planes
    cells = {"coord_sum": (B, gh, gw, 3), "mean": (B, gh, gw, 3), "scatter": (B, gh, gw, 3, 3),
             "nr_pts": ()}
    ints = {"round_map": (round_map, (B, gh, gw)), "seeds": (seeds, (B, R)),
            "nr_rounds": (nr_rounds, (B,))}
    for name, (t, shape) in ints.items():
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"round_finalize: {name} must be a contiguous {shape} int32 "
                             f"tensor on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    for name, shape in cells.items():
        t = getattr(stats, name)
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"round_finalize: stats.{name} must be a contiguous {shape} "
                             f"float32 tensor on {dev}, got {tuple(t.shape)} {t.dtype}")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    sums = empty(B, R, 16)
    labels_map = empty(B, gh, gw, dtype=torch.int32)
    seg = PlaneSegments(nr_planes=empty(B, dtype=torch.int32), n=empty(B, MAXP),
                        coord_sum=empty(B, MAXP, 3), scatter=empty(B, MAXP, 3, 3),
                        normal=empty(B, MAXP, 3), mean=empty(B, MAXP, 3), d=empty(B, MAXP),
                        mse=empty(B, MAXP), score=empty(B, MAXP))
    lib = _build.library()
    nbytes = lib.dplx_round_finalize_scratch_bytes(B, N, R)
    scratch = empty(nbytes, dtype=torch.uint8) if nbytes else None
    # The card of the tensors is made current: the kernel's shared-memory
    # attribute and the launch apply to the current device.
    with torch.cuda.device(dev):
        rc = lib.dplx_round_finalize(
            round_map.data_ptr(), seeds.data_ptr(), nr_rounds.data_ptr(),
            stats.nr_pts.data_ptr(), stats.coord_sum.data_ptr(), stats.mean.data_ptr(),
            stats.scatter.data_ptr(), B, N, R, MAXP,
            float(config.min_region_growing_cells_activated),
            float(config.min_region_planarity_score), sums.data_ptr(),
            labels_map.data_ptr(), *(t.data_ptr() for t in seg),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "round_finalize")
    launches += 1
    return RoundData(round_map=round_map, sums=sums, nr_rounds=nr_rounds), labels_map, seg
