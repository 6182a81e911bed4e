"""Wrapper of the stage-3 epilogue kernel (csrc/rounds.cu): every growing
round's sums in a fixed tree order, its fit and gates, the plane slots, the
cell labels and the slot tables, in one launch of a thread-block cluster a
frame (``cluster_size`` blocks, each owning an aligned span of the frame's
cells, ``span_cells``).

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

# The most span cells whose arrays sit in a block's shared memory at the
# default 256 rounds (csrc/rounds.cu's Layout); a larger span runs from the
# global workspace.
SPAN_CELLS_SHARED = 4096


def span_cells(N: int, C: int) -> int:
    """Cells a block owns: the least power of two >= 32 such that C spans
    cover the frame's N cells (csrc/rounds.cu:span_cells)."""
    per = -(-N // C)
    return max(32, 1 << max(0, (per - 1).bit_length()))


def cluster_size(B: int, N: int, active: dict) -> int:
    """Blocks a frame (1, 2, 4 or 8, the portable cluster sizes), given
    `active`, the clusters of each size the card runs at once
    (``max_clusters``): the largest size whose B clusters run in one wave,
    among the sizes whose span fits in shared memory (all sizes where none
    does) and whose frame has more warps of 32 cells than half the blocks;
    the smallest of those where no size runs in one wave."""
    sizes = [C for C in (1, 2, 4, 8) if C == 1 or -(-N // 32) > C // 2]
    fit = [C for C in sizes if span_cells(N, C) <= SPAN_CELLS_SHARED] or sizes
    one_wave = [C for C in fit if B <= active[C]]
    return max(one_wave) if one_wave else min(fit)


def max_clusters(lib, N: int, R: int) -> dict:
    """{C: clusters of C blocks the current card runs at once} for N cells
    and R rounds (the library's cudaOccupancyMaxActiveClusters); raises
    where the card cannot run one."""
    counts = {C: lib.dplx_round_finalize_max_clusters(N, R, C) for C in (1, 2, 4, 8)}
    for C, n in counts.items():
        _build.check(max(0, -n), f"round_finalize: occupancy of clusters of {C} blocks")
        if n == 0:
            raise RuntimeError(f"round_finalize: the card runs no cluster of {C} blocks "
                               f"at {N} cells and {R} rounds")
    return counts


_active: dict = {}


def round_finalize(round_map: torch.Tensor, seeds: torch.Tensor, nr_rounds: torch.Tensor,
                   stats: CellStats, config: Config, cluster: int | None = None):
    """The growing kernel's round_map (B, gh, gw), seeds (B, R_MAX) and
    nr_rounds (B,), int32, and the cells' CellStats -> (RoundData,
    labels_map (B, gh, gw) int32, PlaneSegments), as ``finalize_grown``.
    ``cluster``: blocks a frame on the card (1, 2, 4 or 8; by default
    ``cluster_size``'s); the outputs are the same bits at every size."""
    global launches
    dev = round_map.device
    if dev.type == "cpu":
        return finalize_grown(round_map, seeds, nr_rounds, stats, config)
    if dev.type != "cuda":
        raise ValueError(f"round_finalize: unsupported device {dev}")
    B, gh, gw = round_map.shape
    N, R = gh * gw, config.max_region_growing_rounds
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
    sums, labels_map, seg = outputs(B, gh, gw, config, dev)
    lib = _build.library()
    if cluster is None and (dev, N, R) not in _active:
        with torch.cuda.device(dev):
            _active[dev, N, R] = max_clusters(lib, N, R)
    C = cluster or cluster_size(B, N, _active[dev, N, R])
    nbytes = lib.dplx_round_finalize_scratch_bytes(B, N, R, C)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    # The card of the tensors is made current: the kernel's shared-memory
    # attribute and the launch apply to the current device. A cluster the
    # card cannot place raises (_build.check); nothing falls back.
    with torch.cuda.device(dev):
        rc = launch(lib, round_map, seeds, nr_rounds, stats, config, sums, labels_map, seg, C,
                    torch.cuda.current_stream(dev).cuda_stream, scratch)
    _build.check(rc, "round_finalize")
    launches += 1
    return RoundData(round_map=round_map, sums=sums, nr_rounds=nr_rounds), labels_map, seg


def outputs(B: int, gh: int, gw: int, config: Config, dev: torch.device):
    """The kernel's outputs, allocated: sums (B, R, 16), labels_map (B, gh,
    gw) int32 and the PlaneSegments."""
    R, MAXP = config.max_region_growing_rounds, config.max_planes

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    return empty(B, R, 16), empty(B, gh, gw, dtype=torch.int32), PlaneSegments(
        nr_planes=empty(B, dtype=torch.int32), n=empty(B, MAXP), coord_sum=empty(B, MAXP, 3),
        scatter=empty(B, MAXP, 3, 3), normal=empty(B, MAXP, 3), mean=empty(B, MAXP, 3),
        d=empty(B, MAXP), mse=empty(B, MAXP), score=empty(B, MAXP))


def launch(lib, round_map: torch.Tensor, seeds: torch.Tensor, nr_rounds: torch.Tensor,
           stats: CellStats, config: Config, sums: torch.Tensor, labels_map: torch.Tensor,
           seg: PlaneSegments, cluster: int, stream: int,
           scratch: torch.Tensor | None = None) -> int:
    """One call of the C entry on checked inputs into ``outputs``' tensors,
    `cluster` blocks a frame, with the global workspace `scratch` (None
    where ``dplx_round_finalize_scratch_bytes`` is 0; a -DDPLX_PROFILE
    build writes its cycles at its end). Returns the CUDA error code."""
    B, gh, gw = round_map.shape
    return lib.dplx_round_finalize(
        round_map.data_ptr(), seeds.data_ptr(), nr_rounds.data_ptr(), stats.nr_pts.data_ptr(),
        stats.coord_sum.data_ptr(), stats.mean.data_ptr(), stats.scatter.data_ptr(), B,
        gh * gw, config.max_region_growing_rounds, config.max_planes, cluster,
        float(config.min_region_growing_cells_activated),
        float(config.min_region_planarity_score), sums.data_ptr(), labels_map.data_ptr(),
        *(t.data_ptr() for t in seg), None if scratch is None else scratch.data_ptr(), stream)
