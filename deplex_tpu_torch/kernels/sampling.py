"""Wrapper of the stage-6 sampling kernels (csrc/sampling.cu): the merged
cell labels, a stable order of the cells by plane, every plane's
three-point hypotheses (fitted, sanitized, padded) and the early-exit
loop's first state, in two launches: the sort on a thread-block cluster a
frame (``launch_plan``: the blocks of a frame's cluster sort it once
between them), then the fits over the whole card, a programmatic dependent
of the sort.

Replaces the XLA fusions of deplex_tpu/ops/ransac.py:105-135 (cell-grid
sampling) and :173-189 (pad_hyp) inside refine_labels (the JAX package has
no pallas_call for them). For CUDA tensors it launches the kernels (or
raises); for CPU tensors it runs the plain twin
``ops.ransac.sample_stage_reference``, which takes any grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops.ransac import (ChunkState, Sampling, chunk_plan, default_draws,
                                         sample_stage_reference)

launches = 0
# Kernel launches a call makes: the sort, then the fits.
LAUNCHES_PER_CALL = 2

# csrc/sampling.cu's sort block: 16 warps; the fits' block: 512 slots, 2 a
# thread; the shared memory a block may take on the H100 (227 KB).
WARPS = 16
THREADS = 32 * WARPS
FIT_SLOTS = 512
FIT_THREADS = 256
# The fewest cells a sort block takes where a frame has cells for more than
# one: below it the cluster's barrier and exchange cost more than the pass
# they split (kernel_bench's [sampling_clusters] sweep, PERF.md).
MIN_SPAN = 384
MAX_SHARED_BYTES = 232448
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def shared_bytes(max_planes: int, cluster: int = 1) -> int:
    """A sort block's shared memory for MAXP planes and `cluster` blocks a
    frame (``shared_bytes`` in csrc/sampling.cu): its tables (the LUT, 16
    warps' counts by id, every block's totals, its offsets, the counts, the
    first positions), for any number of cells; within 227 KB up to MAXP
    2,766 on one block a frame, 1,613 on 16."""
    ints = (WARPS + cluster + 3) * (max_planes + 1) + (max_planes + 2)
    return (4 * ints + 15) // 16 * 16


def span_cells(cells: int, cluster: int) -> int:
    """Cells a sort block owns: the frame's cells split over the cluster,
    rounded up to a multiple of 32 (csrc/sampling.cu's `span`)."""
    return -(-(-(-cells // cluster)) // 32) * 32


class Plan(NamedTuple):
    """A call's two launches: the sort's C blocks a frame (a cluster), the
    cells each takes, its blocks and the waves in which the card runs
    them; the fits' blocks and their waves."""
    cluster: int
    span: int
    blocks: int
    waves: int
    fit_blocks: int
    fit_waves: int


def launch_plan(B: int, cells: int, slots: int, active: dict, fit_per_wave: int) -> Plan:
    """The plan for B frames of `cells` cells and `slots` hypothesis slots
    (MAXP x S*Kc) a frame, given `active`, the sort's clusters of each size
    the card runs at once (``max_clusters``), and `fit_per_wave`, the fit
    blocks it runs at once: among the sizes whose blocks take at least
    MIN_SPAN cells each (one block where none does), the largest whose B
    clusters run in one wave; where none does, the size with the most
    blocks in flight (the smaller on a tie). A sort block owns a span of
    cells (a multiple of 32); a fit block FIT_SLOTS consecutive slots."""
    placed = [C for C in CLUSTER_SIZES if active.get(C, 0) > 0]
    if not placed:
        raise RuntimeError("sample: the card runs no cluster of the sampling kernel")
    sizes = [C for C in placed if C == 1 or -(-cells // C) >= MIN_SPAN] or placed[:1]
    one_wave = [C for C in sizes if B <= active[C]]
    C = max(one_wave) if one_wave else max(sizes, key=lambda c: (active[c] * c, -c))
    span = span_cells(cells, C)
    fit_blocks = B * -(-slots // FIT_SLOTS)
    return Plan(C, span, B * C, -(-B // active[C]), fit_blocks,
                -(-fit_blocks // max(fit_per_wave, 1)))


def max_clusters(lib, max_planes: int) -> dict:
    """{C: clusters of C sort blocks the current card runs at once} at MAXP
    planes (the library's cudaOccupancyMaxActiveClusters); 0 for a size it
    cannot place or whose tables do not fit."""
    counts = {}
    for C in CLUSTER_SIZES:
        n = lib.dplx_ransac_sample_max_clusters(max_planes, C)
        if n < 0 and C <= 8:
            _build.check(-n, f"sample: occupancy of clusters of {C} blocks")
        counts[C] = max(n, 0)
    return counts


_active: dict = {}


def plan_on(lib, dev: torch.device, B: int, cells: int, max_planes: int, slots: int) -> Plan:
    """``launch_plan`` with the occupancy of the card `dev` (cached)."""
    key = (id(lib), dev, max_planes)
    if key not in _active:
        with torch.cuda.device(dev):
            per_sm = lib.dplx_ransac_sample_fit_blocks_per_sm()
            _build.check(max(0, -per_sm), "sample: occupancy of the fit blocks")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            _active[key] = (max_clusters(lib, max_planes), sms * per_sm)
    active, per_wave = _active[key]
    return launch_plan(B, cells, slots, active, per_wave)


def check_inputs(points: torch.Tensor, labels_map: torch.Tensor,
                 merge_labels: torch.Tensor | None, image_width: int, patch_size: int,
                 config: Config) -> int:
    """Raise ValueError unless the inputs are what the sampler takes: (B,
    gh, gw) int32 cell labels, (B, MAXP) int32 merge labels (or None), (B,
    H*W, 3) float32 points of which gh*P x gw*P is a crop, all contiguous
    on one device; returns the image height. Any grid is taken; the
    kernel's own limits are ``check_launch``'s."""
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
    return H


def check_launch(B: int, cells: int, points_per_frame: int, config: Config,
                 chunk_size: int | None = None) -> None:
    """Raise ValueError where the kernels' integer or shared-memory limits
    refuse inputs that ``check_inputs`` takes (only the card's path checks
    these): up to 65,535 frames, 2^30 cells and 2^30 hypothesis slots a
    frame, fewer than 2^31 points a frame, and MAXP up to 2,766 (the sort's
    tables in shared memory). Any grid's cells fit."""
    MAXP = config.max_planes
    Kc, S = chunk_plan(config.ransac_max_iterations, chunk_size)
    need = shared_bytes(MAXP)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"sample: {MAXP} planes take {need} bytes of shared memory a block, "
                         f"over the {MAX_SHARED_BYTES} it may hold")
    if B > 65535 or cells > 1 << 30 or MAXP * S * Kc > 1 << 30 or points_per_frame >= 1 << 31:
        raise ValueError(f"sample: {B} frames of {cells} cells, {points_per_frame} points and "
                         f"{MAXP * S * Kc} hypothesis slots are past the kernels' integer "
                         f"limits")


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
           patch_size: int, config: Config, out: Sampling, cluster: int, stream: int) -> int:
    """One call of the C entry (the sort on `cluster` blocks a frame, then
    the fits) on checked inputs (``check_inputs``, ``check_launch``,
    ``draws_input``'s `ranks`) into `out` (``outputs``); returns its CUDA
    error code."""
    u, batched, raw = ranks
    B, gh, gw = labels_map.shape
    return lib.dplx_ransac_sample(
        labels_map.data_ptr(), None if merge_labels is None else merge_labels.data_ptr(),
        points.data_ptr(), u.data_ptr(), int(raw), int(batched), B, image_height,
        image_width, gh, gw, patch_size, config.max_planes, config.ransac_max_iterations,
        out.hyp.shape[2], out.chunk, cluster, float(config.ransac_inliers_ratio),
        out.cells.data_ptr(), out.cell_order.data_ptr(), out.bounds.data_ptr(),
        out.counts.data_ptr(), out.hyp.data_ptr(), *(t.data_ptr() for t in out.state), stream)


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
    None). Two launches a call (``LAUNCHES_PER_CALL``) on the card, the
    sort on ``launch_plan``'s cluster size."""
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
    check_launch(B, gh * gw, points.shape[1], config, chunk_size)
    ranks = draws_input(draws, raw, B, config, dev)
    out = outputs(B, gh, gw, config, chunk_size, dev)
    if points.data_ptr() % 8:                  # the fits load points as float2s
        points = points.clone()
    lib = _build.library()
    C = plan_on(lib, dev, B, gh * gw, config.max_planes,
                config.max_planes * out.hyp.shape[2]).cluster
    with torch.cuda.device(dev):
        rc = launch(lib, points, labels_map, merge_labels, ranks, H, image_width, patch_size,
                    config, out, C, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sample")
    launches += LAUNCHES_PER_CALL
    return out
