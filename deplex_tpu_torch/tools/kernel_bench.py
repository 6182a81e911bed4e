#!/usr/bin/env python3
"""The hand kernels alone: their times at the main path's serving shape, their
bounds on the H100, and an A/B against another build of ``csrc/``.

    python3 -m deplex_tpu_torch.tools.kernel_bench [--baseline-csrc DIR] [--reps N]
        [--ransac-runs PIXELS,...] [--k2-profile] [--k3-profile] [--k6-profile]
        [--rf-profile]

Run from the repository root on a machine with a CUDA card and nvcc. The
shape is the serving shape of the main path: the TUM frame (480x640, P=10,
48x64 cells), B=64, the default config (400 bins, r_max 256, 64 planes);
the cell-finalize kernel (``cell_finalize``) takes K1's 13 planes of the
ring, the round-finalize kernel (``round_finalize``) K2's outputs and the
cells' statistics, and its library column is the one-hot ``torch.bmm``
pair that computed the region sums before it (``onehot_region_sums``);
the stage-6 chunk-step kernel (``ransac_scores``) takes chunk 0 of the
shipped RANSAC ini's 1000 hypotheses on 8 shifted TUM frames, its B, with
every target +inf so that repeated launches do the same work; its bound
counts float32 instructions, none fused (``FP32_UNFUSED_INSTRUCTIONS_PER_S``).
The sampling kernel (``ransac_sampling``, ``_b1`` the first frame) samples
the RANSAC ring's hypotheses from its stages 1-4 (default draws); its bound
is bytes (``sampling_cost``) and its library column one stable
``torch.sort`` of the merged cell labels (the sort only).
The labels kernel (``pixel_labels``) writes the B=64 ring's uint8 labels
from K3's outputs (``pixel_labels_int32`` int32, ``pixel_labels_b1`` the
first frame, ``pixel_labels_ransac`` stage 6's final pass on the RANSAC
ring's winners); its bound is bytes (``labels_cost``) and its library
column one nearest-neighbour ``interpolate`` of the LUT'd uint8 cell map.
Each kernel is launched through the library's C interface on inputs and
outputs allocated once, behind a spin kernel that lets the host queue the
launches (a ctypes launch takes longer on the host than K3 on the card), so
a time is the kernel's own; the wrappers the path calls add allocation and
checks, timed apart, unprimed, as ``wrapper_ms``. K1 alternates two
rings of 64 distinct frames (78.6 MB, over the 50 MB L2), so its time is
read against HBM as its bound is; K2 and K3 take the stage inputs of a ring
of one frame, as the main path's stage table does.

K3 takes the cell labels and builds the adjacency itself, so its time is
stage 4's as the path runs it; ``merge_planes_icl`` times it on a ring of the
ICL frame (120x160 cells, its ini config).

With ``--baseline-csrc DIR`` (a copy of another revision's ``csrc/``), DIR
is built as a second library; each kernel's outputs from both are compared
and the two are timed in turns (baseline, this tree, this tree, baseline)
on the same inputs. A baseline whose K3 takes the adjacency (the C entry
``dplx_merge_planes``) is timed with ``ops.merge.plane_adjacency`` in each
launch and without it (adjacency built once), in turns around this tree's
K3 (with, without, tree, tree, without, with). A baseline whose stage-6
entry only counts (``dplx_ransac_outliers``) is timed against this tree's
chunk step on the same chunk, its counts held equal. Lines:

  [bench]     kernel, ms, wrapper_ms, bound_ms, bound_by, share of bound
              (round_finalize, pixel_labels and ransac_sampling also
              library_ms);
              cell_finalize_b1 and round_finalize_b1 are the two finalize
              kernels at B=1 (the ring's first frame)
  [ransac_runs] with --ransac-runs: the chunk step with other run sizes
  [k6_profile] with --k6-profile: the chunk step's timeline (phases of the
              blocks that score, finishers, when blocks start)
  [rf_clusters] round finalize at B=64 and B=1 on 1, 2, 4 and 8 blocks a
              frame (the wrapper picks one, cluster_size), outputs equal
  [cf_tiles]  cell finalize at B=64 and B=1 on bands of other heights than
              the wrapper's (tile_plan), the fits a cell, outputs equal
  [rf_profile] with --rf-profile: round finalize's cycles a block by phase
              at B=64 and B=1 (counts, links, coord_tree, means, moment_tree,
              fits, slots, labels_tables)
  [k2_phases] K2 with r_max 0 (staging only), 1, 8 and 256 rounds
  [k2_serpentine] K2 on B=64 serpentine frames (one winding corridor)
  [k2_profile] with --k2-profile: K2's cycles a frame by phase (argmax, seed,
              fill, consume, staging), closure passes, list entries, rounds
  [k3_profile] with --k3-profile: K3's cycles a frame (reading the labels
              and setting the masks, the row scan with the joins known up
              front, rows that test without merging, merging rows' sums and
              refits, write-out) and the count of each kind of row, TUM and
              ICL
  [ab]        kernel, the times in turn order, outputs equal
The last line is a JSON object with every number above.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from deplex_tpu_torch import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.kernels import cellfinal as k_final
from deplex_tpu_torch.kernels import growing as k_grow
from deplex_tpu_torch.kernels import merge as k_merge
from deplex_tpu_torch.kernels import rounds as k_rounds
from deplex_tpu_torch.kernels.cellstats import cell_moment_planes
from deplex_tpu_torch.ops.cellstats import camera_params, moments_band_plan_exists, patch_size
from deplex_tpu_torch.ops.growing import EDGE_NAMES, CellGrid
from deplex_tpu_torch.ops.merge import apply_label_lut, plane_adjacency
from deplex_tpu_torch.pipeline import (compute_cells, depth_tensor, full_float32,
                                       grow_regions, intrinsics_tensor, plane_stages)
from deplex_tpu_torch.tools._common import mean_ms
from deplex_tpu_torch.utils import DepthImage, read_intrinsics

DATA = pathlib.Path(__file__).resolve().parents[2] / "data"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
# The float32 rate counts a fused multiply-add as two operations.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Float32 instructions a second, each counted once: 132 SMs x 128 float32
# lanes x 1.98 GHz. The operations bound of a kernel that must round every
# multiply and add apart (built -fmad=false, so no multiply-add fuses), which
# issues one instruction for each.
FP32_UNFUSED_INSTRUCTIONS_PER_S = 132 * 128 * 1.98e9

_TABLES = ("n", "coord_sum", "scatter", "normal", "mean", "d")


def bound(nbytes: float, ops: float,
          ops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time on the H100 (ms): bytes over HBM rate or operations
    over their peak rate (float32 FLOP/s by default), whichever is longer,
    and which."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---- K1 -------------------------------------------------------------------

def moments_cost(src: torch.Tensor, config: Config) -> tuple[int, int]:
    """(bytes, float32 operations) of one K1 call on `src`: the input read
    once and the 13 planes written once; per pixel 2 back-projection
    multiplies (depth only), 4 sums, and 18 anchored (or 15 centered)
    operations, plus the 13 column partials added per in-cell column."""
    B, H, W = src.shape[:3]
    P = patch_size(H, W, config)
    gh, gw = H // P, W // P
    anchored = moments_band_plan_exists(gh, P, gw * P)
    pixels = B * gh * gw * P * P
    per_pixel = (0 if src.dim() == 4 else 2) + 4 + (18 if anchored else 15)
    nbytes = src.numel() * src.element_size() + 13 * B * gh * gw * 4
    return nbytes, pixels * per_pixel + B * gh * gw * 13 * P


def moments_launcher(lib, src: torch.Tensor, K, config: Config):
    """A K1 launch on a (B, H, W) uint16 ring, its output allocated once.
    Returns (launch, out) with out (13, B, gh, gw) float32. A library
    without a stage-6 entry is an older build whose K1 takes fx, fy, cx
    and cy as launch arguments; this tree's reads them from the card."""
    B, H, W = src.shape
    P = patch_size(H, W, config)
    gh, gw = H // P, W // P
    anchored = int(moments_band_plan_exists(gh, P, gw * P))
    kparams = camera_params(torch.as_tensor(K, dtype=torch.float32).to(src.device))
    thr = float(config.depth_discontinuity_threshold)
    out = torch.empty((13, B, gh, gw), dtype=torch.float32, device=src.device)
    fn = lib.dplx_cell_moments_depth
    if hasattr(lib, "dplx_ransac_chunk_step") or hasattr(lib, LEGACY_RANSAC):
        args = (src.data_ptr(), B, H, W, P, kparams.data_ptr(), thr, anchored, out.data_ptr())
    else:
        fn.argtypes = _build.LEGACY_CELL_MOMENTS_DEPTH
        args = (src.data_ptr(), B, H, W, P, *kparams.tolist(), thr, anchored, out.data_ptr())

    def launch():
        assert src.is_cuda and kparams.is_cuda   # keeps the inputs alive with the launch
        _build.check(fn(*args, _stream()), "cell_moments")
    return launch, out


# ---- cell finalize ----------------------------------------------------------

# Bytes a cell the cell-finalize kernel writes: planar 1, normal and mean 12
# each, d, mse, tol and the bin 4 each, the edge 1; and the copies of its
# input planes that CellStats holds, coord_sum 12 and scatter 36.
CELL_FINALIZE_OUT_BYTES = 1 + 2 * 12 + 4 * 4 + 1
CELL_FINALIZE_COPY_BYTES = 12 + 36


def cells_cost(planes: torch.Tensor, copies: bool = True) -> int:
    """Bytes of one cell-finalize call: the 13 moment planes read once,
    every output written once (its double-precision work, five
    transcendentals a cell, is a fraction of this at 3.35 TB/s). With
    ``copies=False``, without coord_sum and scatter: CellStats holds them as
    (B, gh, gw, 3) and (B, gh, gw, 3, 3) tensors, which the kernel writes
    from its planes; a layout that read them from the planes would not."""
    cells = planes[0].numel()
    return cells * (13 * 4 + CELL_FINALIZE_OUT_BYTES
                    + (CELL_FINALIZE_COPY_BYTES if copies else 0)) + 4


# The two finalize kernels' C entries before the tile plan and the cluster
# launch (a 16 x 32 thread tile; one block a frame), the signatures of an
# older build of csrc/ (--baseline-csrc), which lacks
# dplx_round_finalize_max_clusters.
LEGACY_CELL_FINALIZE = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] * 12
                        + [ctypes.c_int] + [ctypes.c_void_p] * 12)
LEGACY_ROUND_FINALIZE = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                         + [ctypes.c_void_p] * 13)


def legacy_finalize(lib) -> bool:
    """Whether `lib` is an older build whose finalize entries take no tile
    and no cluster size; if so, declares their signatures."""
    if hasattr(lib, "dplx_round_finalize_max_clusters"):
        return False
    lib.dplx_cell_finalize.argtypes = LEGACY_CELL_FINALIZE
    lib.dplx_round_finalize.argtypes = LEGACY_ROUND_FINALIZE
    lib.dplx_round_finalize_scratch_bytes.argtypes = [ctypes.c_int] * 3
    return True


def cells_launcher(lib, planes: torch.Tensor, P: int, config: Config,
                   tile: tuple[int, int] | None = None):
    """A cell-finalize launch with its outputs allocated once, on `tile`
    (rows, cols; the wrapper's plan by default; an older build has its own).
    Returns (launch, outputs in CellGrid order: the nine CellStats fields,
    bins, edges)."""
    _, B, gh, gw = planes.shape
    dev = planes.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    outs = {"planar": empty(B, gh, gw, dtype=torch.bool), "normal": empty(B, gh, gw, 3),
            "mean": empty(B, gh, gw, 3), "d": empty(B, gh, gw), "mse": empty(B, gh, gw),
            "tol": empty(B, gh, gw), "nr_pts": empty(), "coord_sum": empty(B, gh, gw, 3),
            "scatter": empty(B, gh, gw, 3, 3), "bins": empty(B, gh, gw, dtype=torch.int32),
            "edges": empty(B, gh, gw, dtype=torch.uint8)}
    plan = ()
    if not legacy_finalize(lib):
        plan = tile or k_final.tile_plan(
            B, gh, gw, torch.cuda.get_device_properties(dev).multi_processor_count)
    args = (planes.data_ptr(), B, gh, gw, *plan, *k_final.gate_constants(P, config),
            *(outs[k].data_ptr() for k in ("planar", "normal", "mean", "d", "mse", "tol",
                                           "coord_sum", "scatter", "nr_pts", "bins", "edges")))
    keep = (planes, outs)

    def launch():
        assert keep                   # the tensors behind the pointers stay alive
        _build.check(lib.dplx_cell_finalize(*args, _stream()), "cell_finalize")
    order = ("planar", "normal", "mean", "d", "mse", "tol", "nr_pts", "coord_sum", "scatter",
             "bins", "edges")
    return launch, [outs[k] for k in order]


# ---- round finalize ---------------------------------------------------------

def round_cost(round_map: torch.Tensor, config: Config) -> int:
    """Bytes of one round-finalize call: per cell its round (4), coordinate
    sum and mean (12 each) and the six distinct scatter entries (24) read
    once; seeds, round counts and nr_pts read; the sums rows (64 bytes a
    round), the cell labels, plane counts and the slot tables (88 bytes a
    slot) written once."""
    B = round_map.shape[0]
    R, M = config.max_region_growing_rounds, config.max_planes
    return (round_map.numel() * (4 + 12 + 12 + 24) + B * (R * 4 + 4) + 4
            + B * R * 64 + round_map.numel() * 4 + B * 4 + B * M * 88)


def round_launcher(lib, round_map, seeds, nr_rounds, stats, config: Config,
                   cluster: int | None = None):
    """A round-finalize launch with outputs and workspace allocated once,
    `cluster` blocks a frame (the wrapper's choice by default; an older
    build takes one block a frame). Returns (launch, (sums, labels_map,
    *PlaneSegments fields)); launch.scratch is the workspace (a
    -DDPLX_PROFILE build writes its cycles at its end) and launch.blocks
    the blocks launched."""
    B, gh, gw = round_map.shape
    N, R, M = gh * gw, config.max_region_growing_rounds, config.max_planes
    dev = round_map.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    outs = [empty(B, R, 16), empty(B, gh, gw, dtype=torch.int32), empty(B, dtype=torch.int32),
            empty(B, M), empty(B, M, 3), empty(B, M, 3, 3), empty(B, M, 3), empty(B, M, 3),
            empty(B, M), empty(B, M), empty(B, M)]
    if not legacy_finalize(lib):
        C = cluster or k_rounds.cluster_size(B, N, k_rounds.max_clusters(lib, N, R))
        nbytes = lib.dplx_round_finalize_scratch_bytes(B, N, R, C)
        sizes = (B, N, R, M, C)
    else:
        C = 1
        nbytes = lib.dplx_round_finalize_scratch_bytes(B, N, R)
        sizes = (B, N, R, M)
    scratch = empty(max(nbytes, 1), dtype=torch.uint8)
    args = (round_map.data_ptr(), seeds.data_ptr(), nr_rounds.data_ptr(),
            stats.nr_pts.data_ptr(), stats.coord_sum.data_ptr(), stats.mean.data_ptr(),
            stats.scatter.data_ptr(), *sizes,
            float(config.min_region_growing_cells_activated),
            float(config.min_region_planarity_score), *(t.data_ptr() for t in outs),
            scratch.data_ptr())
    keep = (round_map, seeds, nr_rounds, stats, outs, scratch)

    def launch():
        assert keep                   # the tensors behind the pointers stay alive
        _build.check(lib.dplx_round_finalize(*args, _stream()), "round_finalize")
    launch.scratch = scratch[:nbytes]
    launch.blocks = B * C
    return launch, outs


def first_frames(round_map, seeds, nr_rounds, stats, batch: int):
    """Round finalize's inputs cut to their first `batch` frames."""
    return ((round_map[:batch], seeds[:batch], nr_rounds[:batch]),
            type(stats)(*(t if t.dim() == 0 else t[:batch] for t in stats)))


def onehot_region_sums(round_map, seeds, stats, r_max: int) -> torch.Tensor:
    """The region sums as the port computed them before the round-finalize
    kernel: two float32 ``torch.bmm`` products with a (B, r_max, N) one-hot
    weight (the JAX package's MXU idiom). The library column beside that
    kernel; used nowhere in the port. Same (B, r_max, 16) layout; other
    summation order."""
    B, gh, gw = round_map.shape
    N = gh * gw
    dev, f32 = round_map.device, torch.float32
    rm = round_map.reshape(B, N)
    onehot = rm[:, None, :] == torch.arange(r_max, dtype=torch.int32, device=dev)[None, :, None]
    is_seed = seeds[:, :, None] == torch.arange(N, dtype=seeds.dtype, device=dev)
    w = onehot.to(f32) * (1.0 + is_seed.to(f32))
    size = onehot.sum(2).to(f32)
    nr_pts = stats.nr_pts.to(f32)
    n_tot = w.sum(2) * nr_pts
    sum_tot = torch.bmm(w, stats.coord_sum.reshape(B, N, 3))
    mu = sum_tot / torch.clamp(n_tot, min=1.0)[..., None]
    mu_cell = torch.gather(mu, 1, rm.clamp(min=0).to(torch.int64)[..., None].expand(B, N, 3))
    dmu = stats.mean.reshape(B, N, 3) - mu_cell * (rm >= 0)[..., None].to(f32)
    sc = stats.scatter.reshape(B, N, 9)
    feat = torch.stack([sc[..., k] + nr_pts * dmu[..., i] * dmu[..., j] for k, i, j in
                        ((0, 0, 0), (1, 0, 1), (2, 0, 2), (4, 1, 1), (5, 1, 2), (8, 2, 2))], -1)
    return torch.cat([n_tot[..., None], sum_tot, torch.bmm(w, feat), size[..., None],
                      torch.zeros((B, r_max, 5), dtype=f32, device=dev)], dim=-1)


# ---- the stage-6 chunk-step kernel ----------------------------------------

# The scoring entry of older builds of csrc/ (counts only, the update in
# plain ops) and its C signature, for --baseline-csrc.
LEGACY_RANSAC = "dplx_ransac_outliers"
LEGACY_RANSAC_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def ransac_case(src: torch.Tensor, K: torch.Tensor | None, config: Config) -> dict:
    """The chunk step's inputs on a (B, H, W) uint16 batch (with K) or a
    (B, H, W, 3) float32 one (K None) with stage 6 configured: stages 1-4
    and the hypothesis table as the path makes them (default draws). Keys:
    points, cells (the merged cell labels), hyp, order, bounds, n_pts,
    ratio, chunk, chunks, cfg (the config), the keyword arguments of
    ``kernels.ransac.chunk_step`` but s; and for the labels kernel's stage-6
    pass, planes (``pipeline.PlaneCells``), H and refine: the (points,
    winners (B, MAXP, 4), threshold) that stage 6's loop (the chunk-step
    kernel, every chunk) hands its final pass."""
    from deplex_tpu_torch.kernels.ransac import chunk_step
    from deplex_tpu_torch.ops.ransac import refine_cells, sample_stage_reference

    B, H, W = src.shape[:3]
    P = patch_size(H, W, config)
    with full_float32(src.device):
        planes = plane_stages(src, K, config)
        points = planes.points
        sampled = sample_stage_reference(points, planes.labels_map, planes.merge_labels, W, P,
                                         config)
        refine, _ = refine_cells(points, None, planes.labels_map, W, P, config,
                                 merge_labels=planes.merge_labels, step=chunk_step,
                                 write=lambda *winners: winners)
    return {"points": points, "cells": sampled.cells, "hyp": sampled.hyp,
            "order": sampled.cell_order, "bounds": sampled.bounds,
            "n_pts": sampled.state.n_pts,
            "ratio": torch.full((), config.ransac_inliers_ratio, dtype=torch.float32,
                                device=src.device),
            "chunk": sampled.chunk, "chunks": sampled.chunks, "planes": planes, "H": H,
            "refine": refine, "cfg": config,
            "kw": dict(chunk=sampled.chunk, threshold=float(config.ransac_threshold),
                       image_width=W, patch_size=P)}


def ransac_state(case: dict, *, never_done: bool = False):
    """A fresh ``ops.ransac.ChunkState`` for `case`; with never_done every
    target is +inf, so no plane stops and repeated steps of one chunk do
    the same work (a timing loop)."""
    from deplex_tpu_torch.ops.ransac import new_chunk_state

    ratio = torch.full_like(case["ratio"], float("inf")) if never_done else case["ratio"]
    return new_chunk_state(case["n_pts"], ratio, case["chunk"])


def ransac_step_args(case: dict):
    """The positional arguments of ``kernels.ransac.chunk_step`` but the state."""
    return case["points"], case["cells"], case["hyp"], case["order"], case["bounds"]


def ransac_cost(case: dict, done: torch.Tensor) -> tuple[int, int]:
    """(bytes, float32 instructions) of one chunk step on `case`: what this
    data needs. Only the frames not done score, and only their labelled
    cells: each such pixel's 12 bytes read once and 6 instructions (3
    multiplies, 3 adds; none fuses) a hypothesis of the chunk; the cell
    labels and order, the chunk's hypotheses (16 bytes each) and the state
    read, the state written. Time the instructions against
    FP32_UNFUSED_INSTRUCTIONS_PER_S."""
    cells, Kc = case["cells"], case["chunk"]
    B, gh, gw = cells.shape
    MAXP = case["hyp"].shape[1]
    P = case["kw"]["patch_size"]
    scored = (cells >= 1) & (cells <= MAXP) & ~done[:, None, None]
    pixels = int(scored.sum()) * P * P
    state = B * MAXP * (4 + 4 + 1 + 4 + 4 + 8) + B * (1 + 4)
    nbytes = (pixels * 12 + B * gh * gw * (4 + 8) + B * (MAXP + 2) * 8
              + B * MAXP * Kc * 16 + 2 * state)
    return nbytes, pixels * Kc * 6


def ransac_launcher(lib, case: dict, s: int, state, run_cells: int | None = None,
                    losses: torch.Tensor | None = None, with_losses: bool = True):
    """A chunk-step launch of chunk s through the C entry on `state` (make
    it with ``ransac_state(never_done=True)`` to time repeated launches),
    with `run_cells` cells a block (the wrapper's choice by default).
    Returns (launch, losses): the chunk's counts land in losses unless
    with_losses is False (as on the path, which asks for none)."""
    from deplex_tpu_torch.kernels.ransac import check_inputs, run_cells as wrapper_run_cells

    pts, cells, hyp, order, bounds = ransac_step_args(case)
    B, gh, gw = cells.shape
    MAXP, n_hyp = hyp.shape[1:3]
    kw = case["kw"]
    W, P, Kc = kw["image_width"], kw["patch_size"], case["chunk"]
    if losses is None and with_losses:
        losses = torch.zeros((B, MAXP, Kc), dtype=torch.int32, device=pts.device)
    H = check_inputs(pts, cells, hyp, order, bounds, state, s=s, chunk=Kc, image_width=W,
                     patch_size=P, losses=losses)
    args = (pts.data_ptr(), hyp.data_ptr(), order.data_ptr(), bounds.data_ptr(),
            *(t.data_ptr() for t in state), 0 if losses is None else losses.data_ptr(), B, H, W,
            gh, gw, P, MAXP, n_hyp, s, Kc, run_cells or wrapper_run_cells(P),
            kw["threshold"])
    keep = (case, state, losses)

    def launch():
        assert keep                   # the tensors behind the pointers stay alive
        _build.check(lib.dplx_ransac_chunk_step(*args, _stream()), "ransac_scores")
    return launch, losses


def legacy_ransac_launcher(lib, case: dict, s: int):
    """A launch of an older build's counts-only entry (``LEGACY_RANSAC``) on
    chunk s, no frame done, its output and counter allocated once (the
    counts add up over repeated launches). Returns (launch, out)."""
    pts, cells, hyp = case["points"], case["cells"], case["hyp"]
    B, gh, gw = cells.shape
    MAXP, n_hyp = hyp.shape[1:3]
    kw = case["kw"]
    W, P = kw["image_width"], kw["patch_size"]
    n_tab, d_tab = hyp[..., :3].contiguous(), hyp[..., 3].contiguous()
    done = torch.zeros((B,), dtype=torch.bool, device=pts.device)
    scored = torch.zeros((B,), dtype=torch.int32, device=pts.device)
    out = torch.zeros((B, MAXP, case["chunk"]), dtype=torch.int32, device=pts.device)
    fn = getattr(lib, LEGACY_RANSAC)
    fn.argtypes, fn.restype = LEGACY_RANSAC_ARGS, ctypes.c_int
    args = (pts.data_ptr(), cells.data_ptr(), n_tab.data_ptr(), d_tab.data_ptr(),
            done.data_ptr(), scored.data_ptr(), B, pts.numel() // (B * W * 3), W, gh, gw, P,
            MAXP, n_hyp, s, case["chunk"], kw["threshold"], out.data_ptr())
    keep = (pts, cells, n_tab, d_tab, done, scored)

    def launch():
        assert keep
        _build.check(fn(*args, _stream()), "legacy ransac_scores")
    return launch, out


# ---- stage 6: sampling -----------------------------------------------------

def sampling_launcher(lib, points: torch.Tensor, labels_map: torch.Tensor,
                      merge_labels: torch.Tensor | None, image_width: int, patch_size: int,
                      config: Config, draws: torch.Tensor | None = None):
    """A sampling launch through the C entry with its outputs allocated once
    (the kernel writes every element, so repeated launches do the same
    work); draws as ``kernels.sampling.sample`` (the default stream when
    None). Returns (launch, Sampling)."""
    from deplex_tpu_torch.kernels import sampling

    H = sampling.check_inputs(points, labels_map, merge_labels, image_width, patch_size,
                              config)
    B, gh, gw = labels_map.shape
    ranks = sampling.draws_input(draws, None, B, config, points.device)
    out = sampling.outputs(B, gh, gw, config, None, points.device)
    keep = (points, labels_map, merge_labels, ranks)

    def launch():
        assert keep                   # the tensors behind the pointers stay alive
        _build.check(sampling.launch(lib, points, labels_map, merge_labels, ranks, H,
                                     image_width, patch_size, config, out), "ransac_sampling")
    return launch, out


def sampling_cost(points: torch.Tensor, labels_map: torch.Tensor,
                  merge_labels: torch.Tensor | None, image_width: int, patch_size: int,
                  config: Config, sampled, draws: torch.Tensor | None = None) -> int:
    """Bytes of one sampling call, what this data needs: the int32 cell and
    merge labels and the draws read once (the (MAXP, K, 3) int64 raw numbers,
    or the caller's ranks), the points of the distinct pixels the draws
    reach in each frame (12 bytes each; no other point is needed), and every
    output written once (the merged labels, the order, bounds, counts, the
    16-byte hypotheses, the state and the chunk step's zeroed counts);
    `sampled` is the call's ``Sampling``."""
    from deplex_tpu_torch.ops.ransac import default_draws, sample_pixels

    B, gh, gw = labels_map.shape
    MAXP = config.max_planes
    pix = sample_pixels(sampled.cell_order, sampled.bounds, sampled.counts, gw, image_width,
                        patch_size, config, draws=draws,
                        raw=None if draws is not None else default_draws(config, points.device))
    distinct = sum(int(torch.unique(pix[b]).numel()) for b in range(B))
    ranks = default_draws(config, points.device) if draws is None else draws
    n = 4 * labels_map.numel() + (0 if merge_labels is None else 4 * merge_labels.numel())
    n += 8 * ranks.numel() + 12 * distinct
    n += sum(t.numel() * t.element_size() for t in (
        sampled.cells, sampled.cell_order, sampled.bounds, sampled.counts, sampled.hyp,
        *sampled.state))
    return n


def stable_sort_call(cells: torch.Tensor):
    """The sampling kernel's library column, the sort only: one
    ``torch.sort(stable=True)`` of the (B, G) merged cell labels."""
    flat = cells.reshape(cells.shape[0], -1)
    return lambda: torch.sort(flat, dim=1, stable=True)


# ---- K2 -------------------------------------------------------------------

def rounds_inputs(cells: CellGrid, config: Config):
    """(bins int32, mse float32, packed edges uint8) of a batch's CellGrid."""
    return (cells.bins.contiguous(), cells.stats.mse.to(torch.float32).contiguous(),
            cells.edges.contiguous())


def rounds_cost(bins: torch.Tensor, config: Config) -> int:
    """Bytes of one K2 call: 9 per cell in (bins, mse, edges), round_map,
    seeds and nr_rounds out."""
    B, gh, gw = bins.shape
    return B * gh * gw * (4 + 4 + 1 + 4) + B * config.max_region_growing_rounds * 4 + B * 4


def rounds_launcher(lib, bins, mse, packed, config: Config):
    """A K2 launch with outputs and workspace allocated once. A library
    without ``dplx_grow_rounds_scratch_bytes`` (the first version) takes
    one int32 per cell of scratch. Returns (launch, (round_map, seeds,
    nr_rounds))."""
    B, gh, gw = bins.shape
    nb2 = config.histogram_bins_per_coord ** 2
    r_max = config.max_region_growing_rounds
    dev = bins.device
    round_map = torch.empty((B, gh, gw), dtype=torch.int32, device=dev)
    seeds = torch.empty((B, r_max), dtype=torch.int32, device=dev)
    nr_rounds = torch.empty((B,), dtype=torch.int32, device=dev)
    if hasattr(lib, "dplx_grow_rounds_scratch_bytes"):
        scratch = torch.empty((lib.dplx_grow_rounds_scratch_bytes(B, gh, gw, nb2),),
                              dtype=torch.uint8, device=dev)
    else:
        scratch = torch.empty((B, gh * gw), dtype=torch.int32, device=dev)
    args = (bins.data_ptr(), mse.data_ptr(), packed.data_ptr(), B, gh, gw, nb2, r_max,
            config.min_region_growing_candidate_size, round_map.data_ptr(),
            seeds.data_ptr(), nr_rounds.data_ptr(), scratch.data_ptr())
    keep = (bins, mse, packed, scratch)

    def launch():
        assert keep                   # the tensors behind the pointers stay alive
        _build.check(lib.dplx_grow_rounds(*args, _stream()), "grow_rounds")
    return launch, (round_map, seeds, nr_rounds)


def serpentine_depth(height: int, width: int, patch: int, z: int = 2000) -> np.ndarray:
    """A flat wall at depth z whose planar cells form one winding corridor:
    every other row of cells is cut by zero depth, but for one cell at
    alternating ends. The worst case for turn-bound fills."""
    depth = np.full((height, width), z, np.uint16)
    gh, gw = height // patch, width // patch
    for i in range(1, gh, 2):
        gap = gw - 1 if (i // 2) % 2 == 0 else 0
        rows = slice(i * patch, (i + 1) * patch)
        depth[rows, :gw * patch] = 0
        depth[rows, gap * patch:(gap + 1) * patch] = z
    return depth


def random_rounds_case(rng: np.random.Generator, B: int, gh: int, gw: int, nb2: int = 400,
                       nbins: int = 6):
    """Seeded random directed graphs for K2: planar cells (80%), bins from a
    few values, MSE from four values (forced ties inside bins), and random
    asymmetric edge masks, False on the borders as ``admissibility_edges``
    gives them. Returns numpy (bins int32, mse float32, packed uint8)."""
    planar = rng.random((B, gh, gw)) < 0.8
    palette = rng.choice(nb2, size=nbins, replace=False)
    bins = np.where(planar, palette[rng.integers(0, nbins, (B, gh, gw))], -1).astype(np.int32)
    mse = (rng.integers(0, 4, (B, gh, gw)) * 0.25).astype(np.float32)
    p_edge = rng.uniform(0.45, 0.9)
    packed = planar.astype(np.uint8) << 4
    for k, name in enumerate(EDGE_NAMES):
        e = rng.random((B, gh, gw)) < p_edge
        border = {"from_up": (slice(None), 0, slice(None)),
                  "from_down": (slice(None), -1, slice(None)),
                  "from_left": (slice(None), slice(None), 0),
                  "from_right": (slice(None), slice(None), -1)}[name]
        e[border] = False
        packed |= e.astype(np.uint8) << k
    return bins, mse, packed


def random_cell_stats(rng: np.random.Generator, B: int, gh: int, gw: int, device,
                      P: int = 10):
    """Seeded CellStats for round finalize on K2's random graphs: cells of
    P*P points around random centres (x, y within 2 m, z 0.5-5 m), their
    coordinate sums and means, and random symmetric positive semi-definite
    scatters. The fields round finalize does not read are zeros."""
    from deplex_tpu_torch.ops.cellstats import CellStats

    n = np.float32(P * P)
    shape = (B, gh, gw)
    centre = np.stack([rng.uniform(-2000, 2000, shape), rng.uniform(-2000, 2000, shape),
                       rng.uniform(500, 5000, shape)], -1).astype(np.float32)
    coord_sum = (centre * n).astype(np.float32)
    a = rng.normal(0, 30, (B, gh, gw, 3, 3)).astype(np.float32)
    scatter = a @ np.swapaxes(a, -1, -2)
    scatter = ((scatter + np.swapaxes(scatter, -1, -2)) / 2).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    zeros = torch.zeros((B, gh, gw), dtype=torch.float32, device=device)
    return CellStats(planar=zeros > 0, normal=t(np.zeros_like(centre)), mean=t(coord_sum / n),
                     d=zeros, mse=zeros, tol=zeros,
                     nr_pts=torch.full((), float(n), dtype=torch.float32, device=device),
                     coord_sum=t(coord_sum), scatter=t(scatter))


# ---- K3 -------------------------------------------------------------------

# The first K3's C entry (the adjacency built outside, as uint8), which a
# baseline library of an earlier revision of csrc/ exports.
_ASSOC_ENTRY = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                + [ctypes.c_void_p] * 8, ctypes.c_int)


def merge_cost(labels_map: torch.Tensor, segments) -> int:
    """Bytes of one K3 call: the int32 cell labels, plane counts and the six
    tables in; merge labels and the six tables out."""
    B, M = segments.n.shape
    tables = sum(getattr(segments, f).numel() for f in _TABLES) * 4
    return labels_map.numel() * 4 + B * 4 + 2 * tables + B * M * 4


def merge_launcher(lib, labels_map: torch.Tensor, segments, config: Config,
                   profile: torch.Tensor | None = None):
    """A K3 launch (adjacency and merge) with outputs allocated once; with
    `profile` ((B, 9) int64) a -DDPLX_PROFILE build writes its cycles there.
    Returns (launch, (merge_labels, *tables))."""
    B, gh, gw = labels_map.shape
    M = config.max_planes
    ins = [getattr(segments, f).contiguous() for f in _TABLES]
    outs = [torch.empty_like(t) for t in ins]
    labels = torch.empty((B, M), dtype=torch.int32, device=labels_map.device)
    keep = (labels_map, segments.nr_planes, ins, outs, labels, profile)
    args = (labels_map.data_ptr(), segments.nr_planes.data_ptr(), *(t.data_ptr() for t in ins),
            B, gh, gw, M, float(config.min_cos_angle_merge), float(config.max_merge_dist),
            labels.data_ptr(), *(t.data_ptr() for t in outs),
            None if profile is None else profile.data_ptr())

    def launch():
        assert keep                   # the tensors behind the pointers stay alive
        _build.check(lib.dplx_merge_from_labels(*args, _stream()), "merge_planes")
    return launch, (labels, *outs)


def assoc_merge_launcher(lib, labels_map: torch.Tensor, segments, config: Config,
                         with_adjacency: bool):
    """Stage 4 as the first K3 ran it, on a library that exports its C entry
    ``dplx_merge_planes``: ``ops.merge.plane_adjacency`` and the bool-to-uint8
    copy (timed with the launch when `with_adjacency`, else done once here),
    then the kernel. Returns (launch, (merge_labels, *tables))."""
    B, M = segments.n.shape
    fn = lib.dplx_merge_planes
    fn.argtypes, fn.restype = _ASSOC_ENTRY
    ins = [getattr(segments, f).contiguous() for f in _TABLES]
    outs = [torch.empty_like(t) for t in ins]
    labels = torch.empty((B, M), dtype=torch.int32, device=labels_map.device)
    assoc = torch.empty((B, M, M), dtype=torch.uint8, device=labels_map.device)
    keep = (labels_map, segments.nr_planes, ins, outs, labels, assoc)
    args = (assoc.data_ptr(), segments.nr_planes.data_ptr(), *(t.data_ptr() for t in ins), B, M,
            float(config.min_cos_angle_merge), float(config.max_merge_dist),
            labels.data_ptr(), *(t.data_ptr() for t in outs))

    def adjacency():
        assoc.copy_(plane_adjacency(labels_map, M))

    def launch():
        assert keep                   # the tensors behind the pointers stay alive
        if with_adjacency:
            adjacency()
        _build.check(fn(*args, _stream()), "merge_planes")
    if not with_adjacency:
        adjacency()
    return launch, (labels, *outs)


# ---- stage 5: the pixel labels ---------------------------------------------

def labels_cost(labels_map: torch.Tensor, merge_labels: torch.Tensor, image_height: int,
                image_width: int, patch_size: int, dtype: torch.dtype, refine=None) -> int:
    """Bytes of one labels call: the int32 cell labels and merge labels in,
    the (B, H*W) labels out in `dtype`; with stage 6's `refine` (points,
    winners, threshold) also the winners and the points of the labelled
    pixels (this data's: no other pixel's point is needed)."""
    from deplex_tpu_torch.ops.merge import rasterize_labels

    B = labels_map.shape[0]
    n = 4 * (labels_map.numel() + merge_labels.numel())
    n += B * image_height * image_width * torch.empty((), dtype=dtype).element_size()
    if refine is not None:
        labelled = rasterize_labels(labels_map, merge_labels, image_height, image_width,
                                    patch_size) > 0
        n += 12 * int(labelled.sum()) + 4 * refine[1].numel()
    return n


def labels_launcher(lib, labels_map: torch.Tensor, merge_labels: torch.Tensor,
                    image_height: int, image_width: int, patch_size: int,
                    dtype: torch.dtype = torch.uint8, refine=None):
    """A labels launch with its output allocated once; `refine` stage 6's
    (points, winners, threshold). Returns (launch, (labels,))."""
    from deplex_tpu_torch.kernels.labels import DTYPES

    B, gh, gw = labels_map.shape
    M = merge_labels.shape[1]
    out = torch.empty((B, image_height * image_width), dtype=dtype, device=labels_map.device)
    pts, best, thr = refine if refine is not None else (None, None, 0.0)
    keep = (labels_map, merge_labels, pts, best, out)
    args = (labels_map.data_ptr(), merge_labels.data_ptr(),
            None if pts is None else pts.data_ptr(), None if best is None else best.data_ptr(),
            float(thr), B, gh, gw, image_height, image_width, patch_size, M, DTYPES[dtype],
            out.data_ptr())

    def launch():
        assert keep                   # the tensors behind the pointers stay alive
        _build.check(lib.dplx_pixel_labels(*args, _stream()), "pixel_labels")
    return launch, (out,)


def nearest_labels_call(labels_map: torch.Tensor, merge_labels: torch.Tensor,
                        patch_size: int):
    """The library column of the labels kernel: one PyTorch call that
    expands the LUT'd uint8 cell map to pixels,
    ``torch.nn.functional.interpolate(mode="nearest")`` (the LUT applied
    once, outside the call; its output is (B, 1, gh*P, gw*P), the image
    when P divides it)."""
    cell = apply_label_lut(labels_map, merge_labels).to(torch.uint8)[:, None]
    return lambda: torch.nn.functional.interpolate(cell, scale_factor=patch_size,
                                                   mode="nearest")


def _plane_frame(normal: np.ndarray, origin: np.ndarray):
    """(unit normal, origin, two in-plane unit axes) of the plane through
    `origin` with the given normal."""
    normal = normal / np.linalg.norm(normal)
    helper = np.array([1.0, 0.0, 0.0]) if abs(normal[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(normal, helper)
    u /= np.linalg.norm(u)
    return normal, origin, u, np.cross(normal, u)


def _voronoi_labels(rng: np.random.Generator, gh: int, gw: int, k: int,
                    holes: float = 0.15) -> np.ndarray:
    """(gh, gw) labels 1..k of the nearest of k random seeds, with a share of
    cells 0 (not planar)."""
    seeds = np.stack([rng.integers(0, gh, k), rng.integers(0, gw, k)], 1)
    rr, cc = np.mgrid[0:gh, 0:gw]
    dist = (rr[..., None] - seeds[:, 0]) ** 2 + (cc[..., None] - seeds[:, 1]) ** 2
    labels = (np.argmin(dist, -1) + 1).astype(np.int32)
    labels[rng.random((gh, gw)) < holes] = 0
    return labels


MERGE_KINDS = ("coplanar", "mixed", "chain", "full", "edges")


def random_merge_case(rng: np.random.Generator, B: int, gh: int, gw: int, M: int, kind: str):
    """Seeded stage-4 inputs for K3: cell labels and plane tables as
    ``finalize_rounds`` gives them (slot k is label k+1; slots past
    nr_planes zero). Each segment's stats are those of points spread over
    its cells on one plane (scatter about its own mean, thin along the
    normal). Kinds:

      coplanar  Voronoi segments all on one plane: every adjacent pair
                passes, so merge_labels depend on every pair.
      mixed     the segments on three planes (normals 30+ degrees apart).
      chain     one-cell stripes, label j+1 in column j, whose normals turn a
                little from stripe to stripe: one representative fed over
                many rows until its refit normal has turned too far.
      full      all M slots used, nr_planes = M + 5 with labels M+1..M+5 in
                the map (not slots: the stencil skips them) and frame 0 empty.
      edges     coplanar segments, with two extra labels alternating along
                the last row and two down the last column (their pairs there
                are outside the stencil).
    A frame spans about 4 m at about 2 m depth; segments are a few mm thick.
    Returns a dict of numpy arrays: labels_map (B, gh, gw) int32, nr_planes
    (B,) int32, n, d (B, M), coord_sum, normal, mean (B, M, 3), scatter
    (B, M, 3, 3) float32."""
    out = {"labels_map": np.zeros((B, gh, gw), np.int32), "nr_planes": np.zeros(B, np.int32),
           "n": np.zeros((B, M)), "coord_sum": np.zeros((B, M, 3)),
           "scatter": np.zeros((B, M, 3, 3)), "normal": np.zeros((B, M, 3)),
           "mean": np.zeros((B, M, 3)), "d": np.zeros((B, M))}
    spacing = 4000.0 / max(gh, gw)    # mm between neighbouring cells
    for b in range(B):
        if kind == "chain":
            # Stripes tangent to a cylinder of radius 2 m about the camera's
            # y axis, about 100 mm apart: neighbours pass, far stripes do not.
            k = min(M, gw - 1)
            labels = np.zeros((gh, gw), np.int32)
            labels[:, :k] = np.arange(1, k + 1, dtype=np.int32)
            step = rng.uniform(1.5, 4.0) * np.pi / 180
            angles = (np.arange(k) - k / 2) * step
            planes = [_plane_frame(-np.array([np.sin(a), 0.0, np.cos(a)]),
                                   2000.0 * np.array([np.sin(a), 0.0, np.cos(a)]))
                      for a in angles]
            which, centre = np.arange(k), np.arange(k, dtype=float)
        else:
            k = min(M - (4 if kind == "edges" else 0), max(1, gh * gw // 3))
            labels = _voronoi_labels(rng, gh, gw, k)
            n_planes = 3 if kind in ("mixed", "full") else 1
            planes = []
            for tilt in rng.permutation([0.0, 35.0, 70.0])[:n_planes]:
                normal = np.array([np.sin(np.deg2rad(tilt)), 0.1, -1.0])
                normal /= np.linalg.norm(normal)
                planes.append(_plane_frame(normal, -rng.uniform(1500, 2500) * normal))
            which = rng.integers(0, n_planes, k)
            if kind == "edges":
                extra = [k + 1 + i for i in range(4)]
                for i, lab in enumerate(extra[:2]):
                    labels[-1, i::2] = lab
                for i, lab in enumerate(extra[2:]):
                    labels[i:-1:2, -1] = lab
                which = np.concatenate([which, np.zeros(4, int)])
                k += 4
            if kind == "full":
                k = M
                labels = _voronoi_labels(rng, gh, gw, M)
                which = rng.integers(0, n_planes, M)
                stray = rng.random((gh, gw)) < 0.05
                labels[stray] = rng.integers(M + 1, M + 6, int(stray.sum()))
            centre = np.full(k, gw / 2)
        nr = M + 5 if kind == "full" else k
        if kind == "full" and b == 0:
            labels, nr, k = np.zeros_like(labels), 0, 0
        out["labels_map"][b] = labels
        out["nr_planes"][b] = nr
        for slot in range(k):
            normal, origin, u, v = planes[which[slot]]
            cells = np.argwhere(labels == slot + 1)
            rc = cells.mean(0) if len(cells) else rng.uniform(0, [gh, gw])
            mean = origin + ((rc[1] - centre[slot]) * u + (rc[0] - gh / 2) * v) * spacing
            count = float(100 * max(len(cells), 1) + rng.integers(0, 50))
            extent = 0.3 * spacing * np.sqrt(max(len(cells), 1))
            su, sv, sn = (extent * rng.uniform(0.5, 1.5, 2)).tolist() + [rng.uniform(2.0, 8.0)]
            cov = su ** 2 * np.outer(u, u) + sv ** 2 * np.outer(v, v) + sn ** 2 * np.outer(
                normal, normal)
            d = -float(mean @ normal)
            out["n"][b, slot] = count
            out["coord_sum"][b, slot] = count * mean
            out["scatter"][b, slot] = count * cov
            out["normal"][b, slot] = normal if d >= 0 else -normal
            out["mean"][b, slot] = mean
            out["d"][b, slot] = abs(d)
    return {k: (v if v.dtype == np.int32 else v.astype(np.float32)) for k, v in out.items()}


def merge_case_tensors(case: dict, device):
    """A ``random_merge_case`` dict -> (labels_map, PlaneSegments) on `device`."""
    from deplex_tpu_torch.ops.growing import PlaneSegments

    t = {k: torch.from_numpy(v).to(device) for k, v in case.items()}
    zeros = torch.zeros_like(t["n"])
    return t["labels_map"], PlaneSegments(
        nr_planes=t["nr_planes"], n=t["n"], coord_sum=t["coord_sum"], scatter=t["scatter"],
        normal=t["normal"], mean=t["mean"], d=t["d"], mse=zeros, score=zeros)


# ---- the serving shape ------------------------------------------------------

def serving_inputs(dev, batch: int = 64, seed: int = 0) -> dict:
    """The TUM frame at B=64: two rings of distinct (shifted) frames for K1,
    the K2 and K3 inputs of a ring of one frame, K3's inputs of a ring of
    the ICL frame, and the scoring kernel's on 8 shifted TUM frames with
    the shipped RANSAC ini (stage 6 runs at B=8)."""
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    cfg = Config()
    rng = np.random.default_rng(seed)

    def ring():
        return depth_tensor(np.stack([np.roll(tum.data, (int(rng.integers(0, 8)),
                                                         int(rng.integers(0, 8))), (0, 1))
                                      for _ in range(batch)]), dev)

    same = depth_tensor(np.broadcast_to(tum.data, (batch, tum.height, tum.width)), dev)
    Kt = intrinsics_tensor(K, dev)
    planes = cell_moment_planes(same, Kt, cfg)
    cells = compute_cells(same, Kt, cfg)
    bins, mse, packed = rounds_inputs(cells, cfg)
    grown = k_grow.grow_rounds(cells, cfg)
    _, lm, seg = grow_regions(cells, cfg)
    ml = k_merge.merge_planes(lm, seg, cfg)[0]
    icl = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    cfg_icl = Config.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    icl_cells = compute_cells(
        depth_tensor(np.broadcast_to(icl.data, (batch, icl.height, icl.width)), dev),
        intrinsics_tensor(read_intrinsics(str(DATA / "configs" / "ICL_living_room.K")), dev),
        cfg_icl)
    _, icl_lm, icl_seg = grow_regions(icl_cells, cfg_icl)
    cfg_ransac = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini"))
    return {"config": cfg, "K": Kt, "rings": [ring(), ring()], "same": same,
            "planes": planes, "P": cfg.patch_size, "grown": grown,
            "stats": cells.stats, "bins": bins, "mse": mse, "packed": packed,
            "labels_map": lm, "segments": seg, "merge_labels": ml,
            "H": tum.height, "W": tum.width,
            "icl": {"config": cfg_icl, "labels_map": icl_lm, "segments": icl_seg},
            "ransac": ransac_case(ring()[:8], Kt, cfg_ransac)}


def alternate(launches):
    """One call that runs the given launches in turn, one per call."""
    state = {"i": 0}

    def call():
        launches[state["i"] % len(launches)]()
        state["i"] += 1
    return call


def profile_library():
    """This tree's csrc/ built with -DDPLX_PROFILE (once), loaded."""
    path = _build.build_dir() / "profile" / _build.library_path().name
    if not path.exists():
        _build.compile_library(path, extra_flags=("-DDPLX_PROFILE",))
    return _build.load_library(path)


def k2_profile(x, cfg, report) -> None:
    """K2's phases in clock64 cycles, means over the frames of the ring: a
    build of csrc/ with -DDPLX_PROFILE, which writes them to the scratch
    pointer (the frames fit in shared memory, so it is otherwise unused)."""
    plib = profile_library()
    outs = rounds_launcher(plib, x["bins"], x["mse"], x["packed"], cfg)[1]
    bins = x["bins"]
    prof = torch.zeros((bins.shape[0], 8), dtype=torch.int64, device=bins.device)
    args = (bins.data_ptr(), x["mse"].data_ptr(), x["packed"].data_ptr(), bins.shape[0],
            bins.shape[1], bins.shape[2], cfg.histogram_bins_per_coord ** 2,
            cfg.max_region_growing_rounds, cfg.min_region_growing_candidate_size,
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), prof.data_ptr())
    _build.check(plib.dplx_grow_rounds(*args, _stream()), "grow_rounds")
    torch.cuda.synchronize()
    names = ("argmax", "seed", "fill", "consume", "closure_passes", "list_entries", "rounds",
             "staging")
    mean = prof.double().mean(0).tolist()
    report["k2_profile_cycles"] = dict(zip(names, mean))
    print("[k2_profile] " + " ".join(f"{n}={v:.0f}" for n, v in zip(names, mean)), flush=True)


def finalize_sweeps(lib, x, cfg, report, gpu, reps: int) -> None:
    """The two finalize kernels on other plans than the wrappers', at TUM
    B=64 and B=1: round finalize at every cluster size, cell finalize on
    bands of other heights; each one's outputs equal to the plan's."""
    report["rf_clusters"], report["cf_tiles"] = {}, {}
    for batch, (grown, stats, planes) in {64: (x["grown"], x["stats"], x["planes"]),
                                          1: (x["grown1"], x["stats1"], x["planes1"])}.items():
        ref = round_launcher(lib, *grown, stats, cfg)
        ref[0]()
        for C in (1, 2, 4, 8):
            launch, outs = round_launcher(lib, *grown, stats, cfg, cluster=C)
            launch()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(outs, ref[1]))
            ms = mean_ms(launch, reps, prime=True)
            N = grown[0][0].numel()
            active = lib.dplx_round_finalize_max_clusters(N, cfg.max_region_growing_rounds, C)
            report["rf_clusters"][f"b{batch}_c{C}"] = {"ms": ms, "equal": equal,
                                                       "max_active_clusters": active}
            print(f"[rf_clusters] batch={batch} cluster={C} default={ref[0].blocks // batch} "
                  f"max_active_clusters={active} ms={ms:.4f} outputs_equal={equal} "
                  f"gpu={gpu!r}", flush=True)
        _, B, gh, gw = planes.shape
        plan = k_final.tile_plan(B, gh, gw, torch.cuda.get_device_properties(
            planes.device).multi_processor_count)
        ref = cells_launcher(lib, planes, x["P"], cfg)
        ref[0]()
        for rows in sorted({2, 4, 8, 12, 16, 24, 48, plan[0]}):
            launch, outs = cells_launcher(lib, planes, x["P"], cfg, tile=(rows, plan[1]))
            launch()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(outs, ref[1]))
            ms = mean_ms(launch, reps, prime=True)
            fits = sum(len(c) + len(r) for c, r in k_final.tiles(gh, gw, rows, plan[1]))
            report["cf_tiles"][f"b{batch}_rows{rows}"] = {"ms": ms, "equal": equal,
                                                          "fits_per_cell": fits / (gh * gw)}
            print(f"[cf_tiles] batch={batch} rows={rows} cols={plan[1]} plan_rows={plan[0]} "
                  f"fits_per_cell={fits / (gh * gw):.4f} ms={ms:.4f} outputs_equal={equal} "
                  f"gpu={gpu!r}", flush=True)


RF_PROFILE = ("counts", "links", "coord_tree", "means", "moment_tree", "fits", "slots",
              "labels_tables")


def rf_profile(x, cfg, report, gpu) -> None:
    """Round finalize's cycles by phase (RF_PROFILE), at TUM B=64 and B=1:
    a -DDPLX_PROFILE build of csrc/ writes each block's clock64 deltas after
    its workspace; means over the blocks, and their sum."""
    plib = profile_library()
    report["rf_profile"] = {}
    for batch in (64, 1):
        grown, stats = first_frames(*x["grown"], x["stats"], batch)
        launch, _ = round_launcher(plib, *grown, stats, cfg)
        launch()                                   # warm
        launch()
        torch.cuda.synchronize()
        n = launch.blocks * len(RF_PROFILE)
        prof = launch.scratch[-8 * n:].view(torch.int64).reshape(launch.blocks, len(RF_PROFILE))
        mean = dict(zip(RF_PROFILE, prof.double().mean(0).tolist()))
        mean["total"] = sum(mean.values())
        mean["max_block_total"] = float(prof.sum(1).max())
        report["rf_profile"][batch] = {"blocks": launch.blocks, "cycles": mean}
        print(f"[rf_profile] batch={batch} blocks={launch.blocks} "
              + " ".join(f"{k}={v:.0f}" for k, v in mean.items()) + f" gpu={gpu!r}", flush=True)


K3_PROFILE = ("labels_adjacency", "row_scan", "test_rows_cycles", "merge_sums_cycles",
              "refit_cycles", "writeout", "skipped_rows", "test_rows", "merge_rows")


def k3_profile(x, report) -> None:
    """K3's cycles a frame by phase and its rows by kind, means over the
    frames of the TUM and ICL rings (a -DDPLX_PROFILE build)."""
    plib = profile_library()
    report["k3_profile"] = {}
    for frame, (lm, seg, cfg) in {"tum": (x["labels_map"], x["segments"], x["config"]),
                                  "icl": (x["icl"]["labels_map"], x["icl"]["segments"],
                                          x["icl"]["config"])}.items():
        prof = torch.zeros((lm.shape[0], len(K3_PROFILE)), dtype=torch.int64, device=lm.device)
        merge_launcher(plib, lm, seg, cfg, profile=prof)[0]()
        torch.cuda.synchronize()
        mean = dict(zip(K3_PROFILE, prof.double().mean(0).tolist()))
        report["k3_profile"][frame] = mean
        print(f"[k3_profile] frame={frame} batch={lm.shape[0]} "
              + " ".join(f"{n}={v:.1f}" for n, v in mean.items()), flush=True)


def k6_profile(rc, report, gpu) -> None:
    """The chunk step's timeline on chunk 0 of `rc` (a -DDPLX_PROFILE build,
    which writes each block's global-timer stamps to `losses`): the launch's
    span, each phase of the blocks that score (setup: the frame's bounds and
    the run's cells; first_tile: until its first tile's pixels are in place;
    score; ticket: the fence and the frame's ticket; total) at p50/p90/max,
    the finishers' times, and when the scoring blocks start (the waves)."""
    from deplex_tpu_torch.kernels.ransac import run_cells

    plib = profile_library()
    cells = rc["cells"]
    B, gh, gw = cells.shape
    blocks = -(-(gh * gw) // run_cells(rc["kw"]["patch_size"]))
    launch, buf = ransac_launcher(plib, rc, 0, ransac_state(rc, never_done=True))
    if buf.numel() * 4 < B * blocks * 64:
        raise ValueError("k6_profile: the losses buffer is too small for the timeline")
    launch()                                   # warm
    buf.zero_()
    launch()
    torch.cuda.synchronize()
    t = buf.view(torch.int64).reshape(-1)[:B * blocks * 8].reshape(-1, 8).cpu().numpy()
    t = t[t[:, 0] > 0]
    t0 = t[:, 0].min()
    act, fin = (t[:, 6] & 1) == 1, (t[:, 6] & 2) == 2
    spans = {"setup": (0, 1), "first_tile": (1, 2), "score": (2, 3), "ticket": (3, 4),
             "total": (0, 5)}
    us = {name: np.percentile((t[act, j] - t[act, i]) / 1e3, [50, 90, 100]).round(3).tolist()
          for name, (i, j) in spans.items()}
    starts = np.histogram((t[act, 0] - t0) / 1e3, bins=8)
    per_sm = np.bincount(t[act, 7].astype(int))
    out = {"span_us": float((t[:, 5].max() - t0) / 1e3), "scoring_blocks": int(act.sum()),
           "blocks": int(len(t)), "phase_us_p50_p90_max": us,
           "finisher_us": ((t[fin, 5] - t[fin, 4]) / 1e3).round(3).tolist(),
           "finisher_end_us": ((t[fin, 5] - t0) / 1e3).round(3).tolist(),
           "scoring_block_starts": {"count": starts[0].tolist(),
                                    "from_us": starts[1][:-1].round(1).tolist()},
           "scoring_blocks_per_sm": [int(per_sm[per_sm > 0].min()), int(per_sm.max())]}
    report["k6_profile"] = out
    print("[k6_profile] " + " ".join(f"{k}={json.dumps(v).replace(' ', '')}"
                                     for k, v in out.items()) + f" gpu={gpu!r}", flush=True)


def ransac_runs(lib, rc, args, report, gpu) -> None:
    """The chunk step's time with runs of about each of args.ransac_runs
    pixels a block, each run's counts equal to the wrapper's choice's."""
    P = rc["kw"]["patch_size"]
    ref = ransac_launcher(lib, rc, 0, ransac_state(rc))
    ref[0]()
    report["ransac_runs"] = {}
    for pixels in args.ransac_runs:
        cells = max(1, pixels // (P * P))
        launch, losses = ransac_launcher(lib, rc, 0, ransac_state(rc), run_cells=cells)
        launch()
        torch.cuda.synchronize()
        equal = torch.equal(losses, ref[1])
        timed = ransac_launcher(lib, rc, 0, ransac_state(rc, never_done=True), run_cells=cells,
                                with_losses=False)
        ms = mean_ms(timed[0], args.reps, prime=True)
        report["ransac_runs"][pixels] = {"run_cells": cells, "ms": ms, "counts_equal": equal}
        print(f"[ransac_runs] run_pixels={pixels} run_cells={cells} ms={ms:.4f} "
              f"counts_equal={equal} gpu={gpu!r}", flush=True)


def ransac_ab(base_lib, lib, rc, args, report, gpu) -> None:
    """An older build's counts-only scoring entry against this tree's chunk
    step on chunk 0 of the same case, in turns (baseline, tree, tree,
    baseline): the counts equal, and the times."""
    b_launch, b_out = legacy_ransac_launcher(base_lib, rc, 0)
    t_ref = ransac_launcher(lib, rc, 0, ransac_state(rc))
    b_launch(), t_ref[0]()
    torch.cuda.synchronize()
    equal = torch.equal(b_out, t_ref[1])
    t_launch = ransac_launcher(lib, rc, 0, ransac_state(rc, never_done=True),
                               with_losses=False)[0]
    turns = [mean_ms(fn, args.reps, prime=True) for fn in (b_launch, t_launch, t_launch,
                                                            b_launch)]
    report["ab"]["ransac_scores"] = {"baseline_ms": [turns[0], turns[3]],
                                     "tree_ms": [turns[1], turns[2]], "counts_equal": equal}
    print(f"[ab] kernel=ransac_scores batch={rc['cells'].shape[0]} "
          f"baseline_ms={turns[0]:.4f},{turns[3]:.4f} tree_ms={turns[1]:.4f},{turns[2]:.4f} "
          f"counts_equal={equal} gpu={gpu!r}", flush=True)


def merge_outputs_compare(got, ref) -> tuple[bool, float]:
    """(merge labels equal, largest absolute table difference) of two K3
    output tuples (merge_labels, *tables)."""
    return (torch.equal(got[0], ref[0]),
            max(float((a - b).abs().max()) for a, b in zip(got[1:], ref[1:])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-csrc", type=pathlib.Path, default=None,
                    help="another revision's csrc/ to build and time against this tree's")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--ransac-runs", type=lambda v: [int(x) for x in v.split(",")],
                    default=None, metavar="PIXELS,...",
                    help="time the chunk step with blocks of runs of about these many pixels")
    ap.add_argument("--k6-profile", action="store_true",
                    help="the chunk step's timeline by block (a second build with -DDPLX_PROFILE)")
    ap.add_argument("--k2-profile", action="store_true",
                    help="K2's phases in clock64 cycles (a second build with -DDPLX_PROFILE)")
    ap.add_argument("--rf-profile", action="store_true",
                    help="round finalize's phases in clock64 cycles at B=64 and B=1 (a second "
                         "build with -DDPLX_PROFILE)")
    ap.add_argument("--k3-profile", action="store_true",
                    help="K3's phases in clock64 cycles (a second build with -DDPLX_PROFILE)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with full_float32(dev):
        return _bench(args, dev)


def _bench(args, dev) -> int:
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.splitlines()[0].strip()
    lib = _build.library()
    libs = {"tree": lib}
    if args.baseline_csrc is not None:
        path = _build.build_dir() / "baseline" / _build.library_path(args.baseline_csrc).name
        if not path.exists():
            _build.compile_library(path, args.baseline_csrc)
        libs["baseline"] = _build.load_library(path)
    x = serving_inputs(dev)
    cfg = x["config"]
    # The two finalize kernels at B=1 too: the first frame of the ring.
    x["planes1"] = x["planes"][:, :1].contiguous()
    x["grown1"], x["stats1"] = first_frames(*x["grown"], x["stats"], 1)
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("[ptxas]", ln.strip(), flush=True)
    report = {"gpu": gpu, "bench": {}, "ab": {}}
    rc = x["ransac"]
    # The labels kernel: TUM B=64 in uint8 (the serving path) and int32, the
    # ring's first frame, and stage 6's pass on the RANSAC ring's winners.
    HW = (x["H"], x["W"], x["P"])
    lm1, ml1 = x["labels_map"][:1].contiguous(), x["merge_labels"][:1].contiguous()
    rp = rc["planes"]
    labels_cases = {
        "pixel_labels": (x["labels_map"], x["merge_labels"], *HW, torch.uint8),
        "pixel_labels_int32": (x["labels_map"], x["merge_labels"], *HW, torch.int32),
        "pixel_labels_b1": (lm1, ml1, *HW, torch.uint8),
        "pixel_labels_ransac": (rp.labels_map, rp.merge_labels, rc["H"],
                                rc["kw"]["image_width"], rc["kw"]["patch_size"], torch.uint8,
                                rc["refine"])}
    # The sampling kernel on the RANSAC ring (B=8) and its first frame.
    sampling_cases = {name: (rp.points[:B].contiguous(), rp.labels_map[:B].contiguous(),
                             rp.merge_labels[:B].contiguous(), rc["kw"]["image_width"],
                             rc["kw"]["patch_size"], rc["cfg"])
                      for name, B in (("ransac_sampling", 8), ("ransac_sampling_b1", 1))}

    def launchers(which):
        lb = libs[which]
        m = [moments_launcher(lb, r, x["K"], cfg) for r in x["rings"]]
        g = rounds_launcher(lb, x["bins"], x["mse"], x["packed"], cfg)
        out = {"cell_moments": (alternate([m[0][0], m[1][0]]), [m[0][1], m[1][1]]),
               "grow_rounds": (g[0], list(g[1]))}
        if hasattr(lb, "dplx_cell_finalize"):
            out["cell_finalize"] = cells_launcher(lb, x["planes"], x["P"], cfg)
            out["round_finalize"] = round_launcher(lb, *x["grown"], x["stats"], cfg)
            out["cell_finalize_b1"] = cells_launcher(lb, x["planes1"], x["P"], cfg)
            out["round_finalize_b1"] = round_launcher(lb, *x["grown1"], x["stats1"], cfg)
        if hasattr(lb, "dplx_merge_from_labels"):
            out["merge_planes"] = merge_launcher(lb, x["labels_map"], x["segments"], cfg)
        if hasattr(lb, "dplx_pixel_labels"):
            for name, args in labels_cases.items():
                out[name] = labels_launcher(lb, *args)
        if hasattr(lb, "dplx_ransac_sample"):
            for name, args in sampling_cases.items():
                launch, outs = sampling_launcher(lb, *args)
                out[name] = (launch, [*outs[:5], *outs.state])
        return out

    tree = launchers("tree")
    icl = x["icl"]
    tree["merge_planes_icl"] = merge_launcher(lib, icl["labels_map"], icl["segments"],
                                              icl["config"])
    not_done = torch.zeros(rc["cells"].shape[0], dtype=torch.bool, device=dev)
    tree["ransac_scores"] = ransac_launcher(lib, rc, 0, ransac_state(rc, never_done=True),
                                            with_losses=False)
    wrapper_state = ransac_state(rc, never_done=True)
    from deplex_tpu_torch.kernels import cellstats as k_cells
    from deplex_tpu_torch.kernels import labels as k_labels
    from deplex_tpu_torch.kernels import ransac as k_ransac
    from deplex_tpu_torch.kernels import sampling as k_sampling
    from deplex_tpu_torch.ops.ransac import sample_stage_reference
    sampled = {name: sample_stage_reference(*args) for name, args in sampling_cases.items()}
    wrappers = {
        "cell_moments": alternate([lambda r=r: k_cells.cell_moment_planes(r, x["K"], cfg)
                                   for r in x["rings"]]),
        "cell_finalize": lambda: k_final.cell_finalize(x["planes"], x["P"], cfg),
        "grow_rounds": lambda: k_grow.grow_rounds_loop(x["bins"], x["mse"], x["packed"], cfg),
        "round_finalize": lambda: k_rounds.round_finalize(*x["grown"], x["stats"], cfg),
        "cell_finalize_b1": lambda: k_final.cell_finalize(x["planes1"], x["P"], cfg),
        "round_finalize_b1": lambda: k_rounds.round_finalize(*x["grown1"], x["stats1"], cfg),
        "merge_planes": lambda: k_merge.merge_planes(x["labels_map"], x["segments"], cfg),
        "merge_planes_icl": lambda: k_merge.merge_planes(icl["labels_map"], icl["segments"],
                                                         icl["config"]),
        "ransac_scores": lambda: k_ransac.chunk_step(*ransac_step_args(rc), wrapper_state, s=0,
                                                     **rc["kw"]),
        **{name: (lambda a=args: k_labels.pixel_labels(*a[:6], refine=a[6] if len(a) > 6
                                                       else None))
           for name, args in labels_cases.items()},
        **{name: (lambda a=args: k_sampling.sample(*a)) for name, args in sampling_cases.items()},
    }
    costs = {"cell_moments": moments_cost(x["rings"][0], cfg),
             "cell_finalize": (cells_cost(x["planes"]), 0),
             "grow_rounds": (rounds_cost(x["bins"], cfg), 0),
             "round_finalize": (round_cost(x["grown"][0], cfg), 0),
             "cell_finalize_b1": (cells_cost(x["planes1"]), 0),
             "round_finalize_b1": (round_cost(x["grown1"][0], cfg), 0),
             "merge_planes": (merge_cost(x["labels_map"], x["segments"]), 0),
             "merge_planes_icl": (merge_cost(icl["labels_map"], icl["segments"]), 0),
             "ransac_scores": ransac_cost(rc, not_done),
             **{name: (labels_cost(*args), 0) for name, args in labels_cases.items()},
             **{name: (sampling_cost(*args, sampled[name]), 0)
                for name, args in sampling_cases.items()}}
    rates = {"ransac_scores": FP32_UNFUSED_INSTRUCTIONS_PER_S}
    for name, (launch, _) in tree.items():
        ms = mean_ms(launch, args.reps, prime=True)
        wrapper_ms = mean_ms(wrappers[name], args.reps)
        b_ms, by = bound(*costs[name], rates.get(name, FP32_FLOPS_PER_S))
        lib_ms = None
        if name == "round_finalize":
            rm, sd, _ = x["grown"]
            lib_ms = mean_ms(lambda: onehot_region_sums(rm, sd, x["stats"],
                                                        cfg.max_region_growing_rounds),
                             args.reps)
        if name == "pixel_labels":
            lib_ms = mean_ms(nearest_labels_call(x["labels_map"], x["merge_labels"], x["P"]),
                             args.reps)
        if name in sampling_cases:
            lib_ms = mean_ms(stable_sort_call(sampled[name].cells), args.reps, prime=True)
        report["bench"][name] = {"ms": ms, "wrapper_ms": wrapper_ms, "bound_ms": b_ms,
                                 "bound_by": by, "share_of_bound": b_ms / ms,
                                 "bytes": costs[name][0], "flops": costs[name][1],
                                 "library_ms": lib_ms}
        batch = 1 if name.endswith("_b1") else 8 if name.startswith("ransac") or \
            name.endswith("_ransac") else 64
        print(f"[bench] kernel={name} batch={batch} "
              f"ms={ms:.4f} wrapper_ms={wrapper_ms:.4f} "
              f"bound_ms={b_ms:.4f} bound_by={by} share={b_ms / ms:.4f} "
              f"library_ms={lib_ms} gpu={gpu!r}", flush=True)

    phases = {}
    for r_max in (0, 1, 8, cfg.max_region_growing_rounds):
        launch, _ = rounds_launcher(lib, x["bins"], x["mse"], x["packed"],
                                    cfg.replace(max_region_growing_rounds=r_max))
        phases[r_max] = mean_ms(launch, args.reps, prime=True)
    report["k2_phases"] = phases
    print("[k2_phases] " + " ".join(f"r_max_{r}={ms:.4f}" for r, ms in phases.items()),
          flush=True)
    serp = depth_tensor(np.broadcast_to(serpentine_depth(480, 640, cfg.patch_size),
                                        (64, 480, 640)), dev)
    s_in = rounds_inputs(compute_cells(serp, x["K"], cfg), cfg)
    s_launch, s_out = rounds_launcher(lib, *s_in, cfg)
    report["k2_serpentine"] = {"ms": mean_ms(s_launch, args.reps, prime=True),
                               "nr_rounds": int(s_out[2][0]),
                               "planar_cells": int((s_in[2] >> 4).bool()[0].sum())}
    print(f"[k2_serpentine] batch=64 ms={report['k2_serpentine']['ms']:.4f} "
          f"nr_rounds={report['k2_serpentine']['nr_rounds']} "
          f"planar_cells={report['k2_serpentine']['planar_cells']}", flush=True)

    finalize_sweeps(lib, x, cfg, report, gpu, args.reps)
    if args.ransac_runs:
        ransac_runs(lib, rc, args, report, gpu)
    if args.k6_profile:
        k6_profile(rc, report, gpu)
    if args.k2_profile:
        k2_profile(x, cfg, report)
    if args.k3_profile:
        k3_profile(x, report)
    if args.rf_profile:
        rf_profile(x, cfg, report, gpu)

    if "baseline" in libs:
        base = launchers("baseline")
        for name in base:
            (t_launch, t_outs), (b_launch, b_outs) = tree[name], base[name]
            t_launch(), b_launch()
            if name == "cell_moments":      # the alternation: run each ring once
                t_launch(), b_launch()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(t_outs, b_outs))
            turns = [mean_ms(fn, args.reps, prime=True)
                     for fn in (b_launch, t_launch, t_launch, b_launch)]
            report["ab"][name] = {"baseline_ms": [turns[0], turns[3]],
                                  "tree_ms": [turns[1], turns[2]], "outputs_equal": equal}
            batch = 1 if name.endswith("_b1") else 8 if name.startswith("ransac") or \
                name.endswith("_ransac") else 64
            print(f"[ab] kernel={name} batch={batch} "
                  f"baseline_ms={turns[0]:.4f},{turns[3]:.4f} "
                  f"tree_ms={turns[1]:.4f},{turns[2]:.4f} outputs_equal={equal} gpu={gpu!r}",
                  flush=True)
        if hasattr(libs["baseline"], LEGACY_RANSAC):
            ransac_ab(libs["baseline"], lib, rc, args, report, gpu)
        if "merge_planes" not in base:      # a baseline K3 fed the adjacency
            lb = libs["baseline"]
            with_adj = assoc_merge_launcher(lb, x["labels_map"], x["segments"], cfg, True)
            without = assoc_merge_launcher(lb, x["labels_map"], x["segments"], cfg, False)
            t_launch, t_outs = tree["merge_planes"]
            t_launch(), with_adj[0](), without[0]()
            torch.cuda.synchronize()
            labels_equal, table_diff = merge_outputs_compare(t_outs, with_adj[1])
            turns = [mean_ms(fn, args.reps, prime=True) for fn in
                     (with_adj[0], without[0], t_launch, t_launch, without[0], with_adj[0])]
            report["ab"]["merge_planes"] = {
                "baseline_with_adjacency_ms": [turns[0], turns[5]],
                "baseline_kernel_ms": [turns[1], turns[4]], "tree_ms": [turns[2], turns[3]],
                "merge_labels_equal": labels_equal, "max_abs_table_diff": table_diff}
            print(f"[ab] kernel=merge_planes batch=64 "
                  f"baseline_with_adjacency_ms={turns[0]:.4f},{turns[5]:.4f} "
                  f"baseline_kernel_ms={turns[1]:.4f},{turns[4]:.4f} "
                  f"tree_ms={turns[2]:.4f},{turns[3]:.4f} merge_labels_equal={labels_equal} "
                  f"max_abs_table_diff={table_diff:.6g} gpu={gpu!r}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
