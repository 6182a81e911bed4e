"""Wrapper of the stage-3 kernel (csrc/growing.cu): the rounds loop.

Replaces deplex_tpu/ops/pallas_growing.py:_kernel_batched. It reads the
bins, MSE and packed edges of the cell-finalize kernel (``CellGrid``). For
CUDA tensors it launches the kernel (or raises); for CPU tensors it runs the
plain twin ``ops.growing.grow_rounds_loop``.

Every launch adds to its device's counters (``COUNTERS``: frames, their
rounds, frames whose staging took the radix sort rather than the comparison
sort, frames whose rounds ran one row a lane on several warps, and the
radix sorts' passes), an int64 buffer a device that this module owns and
passes to the kernel, so a recorded graph adds to it at every replay. On
the CPU the twin's outputs give the same counts: the rounds from
``nr_rounds``, the sort, the band and the passes from the kernel's rules
(``radix_staged``, ``multiwarp``, ``radix_passes``).
``profiling.counters()`` reads them.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.ops import growing as o_grow

launches = 0

# The largest grid taken: 4 bytes a bin and one bit a cell within 227 KB.
# Below it, a frame whose arrays do not fit in shared memory runs on a
# global workspace (csrc/growing.cu).
_SMEM_LIMIT = 227 * 1024

COUNTERS = ("frames", "rounds", "radix_frames", "multiwarp_frames", "radix_passes")
_counters: dict = {}          # device -> (len(COUNTERS),) int64
# The staging sorts by comparisons where a frame fits in shared memory and
# the sum of its squared bin counts is at most this times its counted cells
# (csrc/growing.cu's kRankRatio), else by the radix sort.
RANK_RATIO = 256
# The radix sort takes the bins in one pass where there are at most this
# many and 16 counters a bin fit its space (csrc/growing.cu's kBinDigits).
BIN_DIGITS = 512


def counters_of(device) -> torch.Tensor:
    """The counters buffer of `device`, zeroed at its first use there. It is
    made outside any recording (a graph recorded first on a card would
    otherwise own it), so the first launch on a card must be an eager one."""
    dev = torch.device(device)
    buf = _counters.get(dev)
    if buf is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"grow_rounds: the counters of {dev} are made at its first "
                               f"eager launch, and this first launch is being recorded")
        buf = _counters[dev] = torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    return buf


def read_counters() -> dict:
    """The counters summed over the devices, each buffer read with one copy."""
    total = [0] * len(COUNTERS)
    for buf in _counters.values():
        total = [a + b for a, b in zip(total, buf.cpu().tolist())]
    return dict(zip(COUNTERS, total))


def reset_counters() -> None:
    for buf in _counters.values():
        buf.zero_()


def _align16(n: int) -> int:
    return (n + 15) & ~15


def sort_space(gh: int, gw: int) -> int:
    """Bytes of the compact layout's bit planes' space, which the radix
    sort's 16-bit counters (256 digits a warp at least) and scratch share
    before the planes are written (csrc/growing.cu's ``Layout.hist``)."""
    planes = _align16(6 * gh * ((gw + 63) // 64) * 8)
    sort = 256 * 16 * 2 + 32 * 4
    return _align16(sort) if planes < sort else planes


def compact_bytes(gh: int, gw: int, nb2: int) -> int:
    """Bytes of a frame's arrays in shared memory (csrc/growing.cu's compact
    ``Layout.total``): the planes' space, then the bins' counts, heads and
    ends, the cells' keys, bins, list and its buffer."""
    n = gh * gw
    return sort_space(gh, gw) + _align16(nb2 * 4) + 2 * _align16(nb2 * 2) + _align16(n * 4) \
        + 3 * _align16(n * 2)


def fits_shared(gh: int, gw: int, nb2: int) -> bool:
    """Whether a frame's arrays fit in the kernel's shared memory
    (``compact_bytes``); else it runs on a global workspace and sorts by
    radix."""
    return gh * gw <= 65535 and nb2 <= 32767 and compact_bytes(gh, gw, nb2) <= _SMEM_LIMIT


def multiwarp(gh: int, gw: int, nb2: int) -> bool:
    """Whether the kernel runs a frame's rounds one row a lane on
    ceil(gh / 32) warps (csrc/growing.cu's dispatch): the frame fits in
    shared memory, and it has at most 512 rows of 3 words (129-192 columns,
    so past the one-warp register band)."""
    return fits_shared(gh, gw, nb2) and gh <= 512 and (gw + 63) // 64 == 3


def radix_staged(bins: torch.Tensor, planar: torch.Tensor, nb2: int) -> torch.Tensor:
    """(B,) bool: whether the kernel's staging sorts each frame's bins by
    radix: the frame does not fit in shared memory, or the sum of its
    squared bin counts (its counted cells: planar, bin in range) is over
    RANK_RATIO times its counted cells."""
    B, gh, gw = bins.shape
    counted = planar & (bins >= 0) & (bins < nb2)
    frame = torch.arange(B, device=bins.device)[:, None, None] * nb2
    keys = torch.where(counted, bins.to(torch.int64) + frame, B * nb2)
    hist = torch.bincount(keys.reshape(-1), minlength=B * nb2 + 1)[:B * nb2].reshape(B, nb2)
    by_rank = (hist * hist).sum(1) <= RANK_RATIO * hist.sum(1)
    return ~by_rank if fits_shared(gh, gw, nb2) else torch.ones_like(by_rank)


def seed_keys(mse: torch.Tensor) -> torch.Tensor:
    """The kernel's seed key of each MSE (csrc/growing.cu's ``seed_key``) as
    int64 in [0, 2^32): NaN 0, then the floats in order with -0 as +0,
    +inf 0xffffffff."""
    m = mse.to(torch.float32).contiguous()
    u = m.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(m == 0, 0, u)
    k = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    k = torch.where(torch.isnan(m), 0, k)
    return torch.where(m == float("inf"), 0xFFFFFFFF, k)


def radix_passes(bins: torch.Tensor, planar: torch.Tensor, mse: torch.Tensor,
                 nb2: int) -> torch.Tensor:
    """(B,) int64: the passes of each frame's radix sort (0 where the
    staging sorts by comparisons, ``radix_staged``, or no cell is counted):
    one a byte of the seed key that the counted cells' keys differ in, then
    the bins' (none where nb2 is 1 and a key pass ran): one pass where
    ``BIN_DIGITS`` bins and their counters fit (16 of 16 or 32 bits a bin
    in ``sort_space``, or on the global workspace), else one a byte."""
    B, gh, gw = bins.shape
    counted = (planar & (bins >= 0) & (bins < nb2)).reshape(B, -1)
    keys = seed_keys(mse).reshape(B, -1, 1)
    digits = (keys >> torch.tensor([0, 8, 16, 24], device=keys.device)) & 0xFF
    hi = torch.where(counted[..., None], digits, -1).amax(1)
    lo = torch.where(counted[..., None], digits, 256).amin(1)
    key_passes = (hi > lo).sum(1)
    fits = fits_shared(gh, gw, nb2)
    one_bin = nb2 <= BIN_DIGITS and (not fits or 16 * nb2 * 2 + 32 * 4 <= sort_space(gh, gw))
    bin_passes = 1 if one_bin or nb2 <= 256 else ((nb2 - 1).bit_length() + 7) // 8
    passes = torch.where((key_passes > 0) & (nb2 <= 1), key_passes, key_passes + bin_passes)
    live = radix_staged(bins, planar, nb2) & counted.any(1)
    return torch.where(live, passes, 0)


def grow_rounds_loop(bins: torch.Tensor, mse: torch.Tensor, edges: torch.Tensor,
                     config: Config):
    """Launch the kernel on (B, gh, gw) int32 bins, float32 mse and uint8
    packed edges (``ops.growing.pack_edges``), CUDA tensors. Returns
    round_map (B, gh, gw), seeds (B, R_MAX) and nr_rounds (B,), all int32."""
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
    smem = 4 * (nb2 + (gh * gw + 31) // 32)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"grow_rounds: {nb2} bins and a {gh}x{gw} grid need "
                         f"{smem} bytes of shared memory, over {_SMEM_LIMIT}")
    dev = bins.device
    round_map, seeds, nr_rounds = outputs(B, gh, gw, config, dev)
    lib = _build.library()
    scratch = torch.empty((lib.dplx_grow_rounds_scratch_bytes(B, gh, gw, nb2),),
                          dtype=torch.uint8, device=dev)
    # The card of the tensors is made current: the kernel's shared-memory
    # attribute and the launch apply to the current device.
    with torch.cuda.device(dev):
        rc = launch(lib, bins, mse, edges, config, round_map, seeds, nr_rounds, scratch,
                    counters_of(dev), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "grow_rounds")
    launches += 1
    return round_map, seeds, nr_rounds


def outputs(B: int, gh: int, gw: int, config: Config, dev: torch.device):
    """The kernel's outputs, allocated: round_map (B, gh, gw), seeds (B,
    R_MAX) and nr_rounds (B,), all int32."""
    return (torch.empty((B, gh, gw), dtype=torch.int32, device=dev),
            torch.empty((B, config.max_region_growing_rounds), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def launch(lib, bins: torch.Tensor, mse: torch.Tensor, edges: torch.Tensor, config: Config,
           round_map: torch.Tensor, seeds: torch.Tensor, nr_rounds: torch.Tensor,
           scratch: torch.Tensor, counters: torch.Tensor, stream: int) -> int:
    """One call of the C entry on checked inputs into round_map, seeds and
    nr_rounds, with the workspace `scratch` (a -DDPLX_PROFILE build writes
    its cycles there) and the int64 `counters` it adds to. Returns the CUDA
    error code."""
    B, gh, gw = bins.shape
    return lib.dplx_grow_rounds(
        bins.data_ptr(), mse.data_ptr(), edges.data_ptr(), B, gh, gw,
        config.histogram_bins_per_coord ** 2, config.max_region_growing_rounds,
        config.min_region_growing_candidate_size, round_map.data_ptr(), seeds.data_ptr(),
        nr_rounds.data_ptr(), scratch.data_ptr(), counters.data_ptr(), stream)


def grow_rounds(cells: o_grow.CellGrid, config: Config):
    """Stage-3 rounds loop of a batch's CellGrid -> round_map (B, gh, gw),
    seeds (B, R_MAX) and nr_rounds (B,), all int32."""
    dev = cells.bins.device
    if dev.type == "cpu":
        edges, _ = o_grow.unpack_edges(cells.edges)
        out = o_grow.grow_rounds_loop(cells.bins, cells.stats.mse, edges,
                                      cells.stats.planar, config)
        nb2 = config.histogram_bins_per_coord ** 2
        radix = radix_staged(cells.bins, cells.stats.planar, nb2)
        rows = len(radix) if multiwarp(*cells.bins.shape[1:], nb2) else 0
        passes = radix_passes(cells.bins, cells.stats.planar, cells.stats.mse, nb2)
        counters_of(dev).add_(torch.tensor([len(radix), int(out[2].sum()), int(radix.sum()),
                                            rows, int(passes.sum())]))
        return out
    if dev.type != "cuda":
        raise ValueError(f"grow_rounds: unsupported device {dev}")
    return grow_rounds_loop(cells.bins, cells.stats.mse, cells.edges, config)
