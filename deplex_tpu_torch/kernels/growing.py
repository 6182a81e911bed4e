"""Wrapper of the stage-3 kernel (csrc/growing.cu): the rounds loop.

Replaces deplex_tpu/ops/pallas_growing.py:_kernel_batched. For CUDA tensors
it computes the bins and edge masks (plain ops), launches the kernel (or
raises) and recovers the per-round sums with ``region_sums``; for CPU
tensors it runs the plain twin ``ops.growing.grow_rounds``.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.cellstats import CellStats
from deplex_tpu_torch.ops.growing import (RoundData, admissibility_edges,
                                          grow_rounds as grow_rounds_reference,
                                          pack_edges, region_sums)
from deplex_tpu_torch.ops.histogram import normal_bins

launches = 0

# The largest grid taken: 4 bytes a bin and one bit a cell within 227 KB.
# Below it, a frame whose arrays do not fit in shared memory runs on a
# global workspace (csrc/growing.cu).
_SMEM_LIMIT = 227 * 1024


def grow_rounds_loop(bins: torch.Tensor, mse: torch.Tensor, edges: torch.Tensor,
                     config: Config):
    """Launch the kernel on (B, gh, gw) int32 bins, float32 mse and uint8
    packed edges (``ops.growing.pack_edges``). Returns round_map (B, gh, gw),
    seeds (B, R_MAX) and nr_rounds (B,), all int32."""
    global launches
    for name, t, dtype in (("bins", bins, torch.int32), ("mse", mse, torch.float32),
                           ("edges", edges, torch.uint8)):
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous() \
                or t.shape != bins.shape or t.dim() != 3:
            raise ValueError(f"grow_rounds: {name} must be a contiguous CUDA "
                             f"(B, gh, gw) {dtype}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    B, gh, gw = bins.shape
    nb2 = config.histogram_bins_per_coord ** 2
    r_max = config.max_region_growing_rounds
    smem = 4 * (nb2 + (gh * gw + 31) // 32)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"grow_rounds: {nb2} bins and a {gh}x{gw} grid need "
                         f"{smem} bytes of shared memory, over {_SMEM_LIMIT}")
    dev = bins.device
    round_map = torch.empty((B, gh, gw), dtype=torch.int32, device=dev)
    seeds = torch.empty((B, r_max), dtype=torch.int32, device=dev)
    nr_rounds = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = _build.library()
    scratch = torch.empty((lib.dplx_grow_rounds_scratch_bytes(B, gh, gw, nb2),),
                          dtype=torch.uint8, device=dev)
    rc = lib.dplx_grow_rounds(
        bins.data_ptr(), mse.data_ptr(), edges.data_ptr(), B, gh, gw, nb2, r_max,
        config.min_region_growing_candidate_size, round_map.data_ptr(),
        seeds.data_ptr(), nr_rounds.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "grow_rounds")
    launches += 1
    return round_map, seeds, nr_rounds


def grow_rounds(stats: CellStats, config: Config) -> RoundData:
    """Stage-3 rounds loop + per-round sums for batched CellStats."""
    dev = stats.planar.device
    if dev.type == "cpu":
        return grow_rounds_reference(stats, config)
    if dev.type != "cuda":
        raise ValueError(f"grow_rounds: unsupported device {dev}")
    bins = normal_bins(stats.normal, stats.planar,
                       config.histogram_bins_per_coord).to(torch.int32).contiguous()
    edges = pack_edges(admissibility_edges(stats, config), stats.planar).contiguous()
    round_map, seeds, nr_rounds = grow_rounds_loop(
        bins, stats.mse.to(torch.float32).contiguous(), edges, config)
    sums = region_sums(round_map, seeds, stats, config.max_region_growing_rounds)
    return RoundData(round_map=round_map, sums=sums, nr_rounds=nr_rounds)
