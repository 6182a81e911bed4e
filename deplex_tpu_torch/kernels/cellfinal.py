"""Wrapper of the stage-1 epilogue kernel (csrc/cellfinal.cu): every cell's
plane fit and gates, its normal bin and its packed edge byte, in one launch
whose blocks take tiles of whole grid rows (``tile_plan``) and recompute the
fits of each tile's one-cell ring.

Replaces the XLA fusions of deplex_tpu/ops/cellstats.py:finalize_cell_stats,
deplex_tpu/ops/histogram.py:normal_bins and
deplex_tpu/ops/growing.py:admissibility_edges. For CUDA tensors it launches
the kernel (or raises); for CPU tensors it runs the plain twin
``ops.growing.finalize_cells``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.cellstats import CellStats, moments_from_planes
from deplex_tpu_torch.ops.growing import CellGrid, finalize_cells

launches = 0

# Tiles: at most this many columns (wider grids go in column strips of equal
# width), about this many cells (a block's 16 warps take ~3 groups of 32
# cells each), and no fewer rows than this.
TILE_MAX_COLS = 128
TILE_CELLS = 1536
TILE_MIN_ROWS = 2


def tile_plan(B: int, gh: int, gw: int, sm_count: int) -> tuple[int, int]:
    """The (rows, cols) of a block's tile on a (B, gh, gw) grid: strips of
    equal width up to TILE_MAX_COLS columns, bands of ~TILE_CELLS cells of
    equal height; thinner bands (down to TILE_MIN_ROWS rows) while the
    launch has fewer blocks than half the card's SMs."""
    strips = -(-gw // TILE_MAX_COLS)
    cols = -(-gw // strips)
    bands = -(-gh // max(1, min(gh, TILE_CELLS // cols)))
    while B * strips * bands < sm_count // 2 and -(-gh // bands) > TILE_MIN_ROWS:
        bands += 1
    return -(-gh // bands), cols


def tiles(gh: int, gw: int, rows: int, cols: int):
    """Each block's tile of a frame, in launch order: (cells, ring), the
    (row, col) cells it writes and the ring cells in the grid whose fits it
    recomputes for their edges (the tile's four neighbours, corners not)."""
    out = []
    for r0 in range(0, gh, rows):
        for c0 in range(0, gw, cols):
            nr, nc = min(rows, gh - r0), min(cols, gw - c0)
            cells = [(r0 + i, c0 + j) for i in range(nr) for j in range(nc)]
            ring = ([(r0 - 1, c0 + j) for j in range(nc)] if r0 > 0 else []) \
                + ([(r0 + nr, c0 + j) for j in range(nc)] if r0 + nr < gh else []) \
                + ([(r0 + i, c0 - 1) for i in range(nr)] if c0 > 0 else []) \
                + ([(r0 + i, c0 + nc) for i in range(nr)] if c0 + nc < gw else [])
            out.append((cells, ring))
    return out


_sm_counts: dict = {}


def sm_count(dev: torch.device) -> int:
    """The SMs of the card `dev` (cached): ``tile_plan``'s `sm_count`."""
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_counts[dev]


def gate_constants(P: int, config: Config) -> tuple:
    """The kernel's float constants, as the twin's float32 ops see them
    (ctypes rounds each Python float to float32 as torch rounds a Python
    scalar for a float32 tensor) and the bin count: n, valid_thr, max_disc,
    sigma_coeff, sigma_margin, sin_angle, tol_lo, tol_hi, min_cos,
    polar_scale, azimuth_scale, pi, nr_bins."""
    nr_bins = config.histogram_bins_per_coord
    sin_angle = math.sqrt(max(0.0, 1.0 - min(config.min_cos_angle_merge, 1.0) ** 2))
    # ops/histogram.py:normal_bins' folded float32 scales.
    polar_scale = float(np.float32(nr_bins - 1) / np.float32(math.pi))
    azimuth_scale = float(np.float32(nr_bins - 1) / np.float32(2 * math.pi))
    return (float(P * P), float((P * P * 3) // config.min_pts_per_cell),
            float(config.max_number_depth_discontinuity), float(config.depth_sigma_coeff),
            float(config.depth_sigma_margin), sin_angle, 20.0, float(config.max_merge_dist),
            float(config.min_cos_angle_merge), polar_scale, azimuth_scale, math.pi, nr_bins)


def cell_finalize(planes: torch.Tensor, P: int, config: Config) -> CellGrid:
    """(13, B, gh, gw) float32 moment planes in kernel order (K1's output,
    ``kernels.cellstats.cell_moment_planes``) and the cell side P ->
    CellGrid: CellStats, (B, gh, gw) int32 bins, (B, gh, gw) uint8 edges."""
    global launches
    dev = planes.device
    if dev.type == "cpu":
        return finalize_cells(moments_from_planes(planes), P, config)
    if dev.type != "cuda":
        raise ValueError(f"cell_finalize: unsupported device {dev}")
    if planes.dim() != 4 or planes.shape[0] != 13 or planes.dtype != torch.float32 \
            or not planes.is_contiguous():
        raise ValueError("cell_finalize: planes must be a contiguous (13, B, gh, gw) "
                         f"float32 tensor, got {tuple(planes.shape)} {planes.dtype}")
    _, B, gh, gw = planes.shape
    cells = outputs(B, gh, gw, dev)
    lib = _build.library()
    rows, cols = tile_plan(B, gh, gw, sm_count(dev))
    # The card of the tensors is made current: the runtime launches there.
    with torch.cuda.device(dev):
        rc = launch(lib, planes, P, config, cells, rows, cols,
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "cell_finalize")
    launches += 1
    return cells


def outputs(B: int, gh: int, gw: int, dev: torch.device) -> CellGrid:
    """The kernel's outputs on a (B, gh, gw) grid, allocated (it writes
    every element)."""
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    stats = CellStats(planar=empty(B, gh, gw, dtype=torch.bool), normal=empty(B, gh, gw, 3),
                      mean=empty(B, gh, gw, 3), d=empty(B, gh, gw), mse=empty(B, gh, gw),
                      tol=empty(B, gh, gw), nr_pts=empty(),
                      coord_sum=empty(B, gh, gw, 3), scatter=empty(B, gh, gw, 3, 3))
    return CellGrid(stats=stats, bins=empty(B, gh, gw, dtype=torch.int32),
                    edges=empty(B, gh, gw, dtype=torch.uint8))


def launch(lib, planes: torch.Tensor, P: int, config: Config, out: CellGrid, rows: int,
           cols: int, stream: int) -> int:
    """One call of the C entry on checked (13, B, gh, gw) planes into `out`
    (``outputs``), on tiles of `rows` x `cols` cells (``tile_plan``).
    Returns the CUDA error code."""
    _, B, gh, gw = planes.shape
    st = out.stats
    return lib.dplx_cell_finalize(
        planes.data_ptr(), B, gh, gw, rows, cols, *gate_constants(P, config),
        st.planar.data_ptr(), st.normal.data_ptr(), st.mean.data_ptr(), st.d.data_ptr(),
        st.mse.data_ptr(), st.tol.data_ptr(), st.coord_sum.data_ptr(), st.scatter.data_ptr(),
        st.nr_pts.data_ptr(), out.bins.data_ptr(), out.edges.data_ptr(), stream)
