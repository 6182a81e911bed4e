#!/usr/bin/env python3
"""The hand kernels alone: their times at the main path's serving shape, their
bounds on the H100, and an A/B against another build of ``csrc/``.

    python3 -m deplex_tpu_torch.tools.kernel_bench [--baseline-csrc DIR] [--reps N]

Run from the repository root on a machine with a CUDA card and nvcc. The
shape is the serving shape of the main path: the TUM frame (480x640, P=10,
48x64 cells), B=64, the default config (400 bins, r_max 256, 64 planes).
Each kernel is launched through the library's C interface on inputs and
outputs allocated once, behind a spin kernel that lets the host queue the
launches (a ctypes launch takes longer on the host than K3 on the card), so
a time is the kernel's own; the wrappers add allocation, checks and, for
K1, the reshaping of the 13 planes (``moments_from_planes``), timed apart,
unprimed, as ``wrapper_ms``. K1 alternates two
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
K3 (with, without, tree, tree, without, with). Lines:

  [bench]     kernel, ms, wrapper_ms, bound_ms, bound_by, share of bound
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
from deplex_tpu_torch.kernels import growing as k_grow
from deplex_tpu_torch.ops.cellstats import moments_band_plan_exists, patch_size
from deplex_tpu_torch.ops.growing import (EDGE_NAMES, admissibility_edges, finalize_rounds,
                                          pack_edges)
from deplex_tpu_torch.ops.histogram import normal_bins
from deplex_tpu_torch.ops.merge import plane_adjacency
from deplex_tpu_torch.pipeline import compute_cell_stats, depth_tensor
from deplex_tpu_torch.utils import DepthImage, read_intrinsics

DATA = pathlib.Path(__file__).resolve().parents[2] / "data"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

_TABLES = ("n", "coord_sum", "scatter", "normal", "mean", "d")


# A spin of about 10 ms on the card ahead of the timed launches (cycles).
PRIME_CYCLES = 20_000_000


def cuda_ms(fn, reps: int, warmup: int = 3, prime: bool = False) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up. With
    `prime`, a spin kernel runs first so that the host queues the launches
    while the card is busy: they then run back to back, and a kernel shorter
    than its launch on the host is timed by the card, not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prime:
        torch.cuda._sleep(PRIME_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time on the H100 (ms): bytes over HBM rate or float32
    operations over the float32 peak, whichever is longer, and which."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS_PER_S
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
    Returns (launch, out) with out (13, B, gh, gw) float32."""
    B, H, W = src.shape
    P = patch_size(H, W, config)
    gh, gw = H // P, W // P
    anchored = int(moments_band_plan_exists(gh, P, gw * P))
    k = [float(v) for v in torch.as_tensor(K, dtype=torch.float32).reshape(9)]
    thr = float(config.depth_discontinuity_threshold)
    out = torch.empty((13, B, gh, gw), dtype=torch.float32, device=src.device)
    args = (src.data_ptr(), B, H, W, P, k[0], k[4], k[2], k[5], thr, anchored,
            out.data_ptr())

    def launch():
        assert src.is_cuda            # keeps the ring alive with the launch
        _build.check(lib.dplx_cell_moments_depth(*args, _stream()), "cell_moments")
    return launch, out


# ---- K2 -------------------------------------------------------------------

def rounds_inputs(stats, config: Config):
    """(bins int32, mse float32, packed edges uint8) of batched CellStats."""
    bins = normal_bins(stats.normal, stats.planar,
                       config.histogram_bins_per_coord).to(torch.int32).contiguous()
    packed = pack_edges(admissibility_edges(stats, config), stats.planar).contiguous()
    return bins, stats.mse.to(torch.float32).contiguous(), packed


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


def unpack_edges(packed: torch.Tensor):
    """Packed edge bytes -> (edge dict of ``admissibility_edges``, planar)."""
    edges = {name: ((packed >> k) & 1).bool() for k, name in enumerate(EDGE_NAMES)}
    return edges, ((packed >> 4) & 1).bool()


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
    the K2 and K3 inputs of a ring of one frame, and K3's inputs of a ring
    of the ICL frame."""
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    cfg = Config()
    rng = np.random.default_rng(seed)

    def ring():
        return depth_tensor(np.stack([np.roll(tum.data, (int(rng.integers(0, 8)),
                                                         int(rng.integers(0, 8))), (0, 1))
                                      for _ in range(batch)]), dev)

    same = depth_tensor(np.broadcast_to(tum.data, (batch, tum.height, tum.width)), dev)
    Kt = torch.as_tensor(K)
    stats = compute_cell_stats(same, Kt, cfg)
    bins, mse, packed = rounds_inputs(stats, cfg)
    lm, seg = finalize_rounds(k_grow.grow_rounds(stats, cfg), cfg)
    icl = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    cfg_icl = Config.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    icl_stats = compute_cell_stats(
        depth_tensor(np.broadcast_to(icl.data, (batch, icl.height, icl.width)), dev),
        torch.as_tensor(read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))), cfg_icl)
    icl_lm, icl_seg = finalize_rounds(k_grow.grow_rounds(icl_stats, cfg_icl), cfg_icl)
    return {"config": cfg, "K": Kt, "rings": [ring(), ring()], "same": same,
            "stats": stats, "bins": bins, "mse": mse, "packed": packed,
            "labels_map": lm, "segments": seg,
            "icl": {"config": cfg_icl, "labels_map": icl_lm, "segments": icl_seg}}


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
    ap.add_argument("--k2-profile", action="store_true",
                    help="K2's phases in clock64 cycles (a second build with -DDPLX_PROFILE)")
    ap.add_argument("--k3-profile", action="store_true",
                    help="K3's phases in clock64 cycles (a second build with -DDPLX_PROFILE)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
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
    report = {"gpu": gpu, "bench": {}, "ab": {}}

    def launchers(which):
        lb = libs[which]
        m = [moments_launcher(lb, r, x["K"], cfg) for r in x["rings"]]
        g = rounds_launcher(lb, x["bins"], x["mse"], x["packed"], cfg)
        out = {"cell_moments": (alternate([m[0][0], m[1][0]]), [m[0][1], m[1][1]]),
               "grow_rounds": (g[0], list(g[1]))}
        if hasattr(lb, "dplx_merge_from_labels"):
            out["merge_planes"] = merge_launcher(lb, x["labels_map"], x["segments"], cfg)
        return out

    tree = launchers("tree")
    icl = x["icl"]
    tree["merge_planes_icl"] = merge_launcher(lib, icl["labels_map"], icl["segments"],
                                              icl["config"])
    from deplex_tpu_torch.kernels import cellstats as k_cells, merge as k_merge
    wrappers = {
        "cell_moments": alternate([lambda r=r: k_cells.cell_moments(r, x["K"], cfg)
                                   for r in x["rings"]]),
        "grow_rounds": lambda: k_grow.grow_rounds_loop(x["bins"], x["mse"], x["packed"], cfg),
        "merge_planes": lambda: k_merge.merge_planes(x["labels_map"], x["segments"], cfg),
        "merge_planes_icl": lambda: k_merge.merge_planes(icl["labels_map"], icl["segments"],
                                                         icl["config"]),
    }
    costs = {"cell_moments": moments_cost(x["rings"][0], cfg),
             "grow_rounds": (rounds_cost(x["bins"], cfg), 0),
             "merge_planes": (merge_cost(x["labels_map"], x["segments"]), 0),
             "merge_planes_icl": (merge_cost(icl["labels_map"], icl["segments"]), 0)}
    for name, (launch, _) in tree.items():
        ms = cuda_ms(launch, args.reps, prime=True)
        wrapper_ms = cuda_ms(wrappers[name], args.reps)
        b_ms, by = bound(*costs[name])
        report["bench"][name] = {"ms": ms, "wrapper_ms": wrapper_ms, "bound_ms": b_ms,
                                 "bound_by": by, "share_of_bound": b_ms / ms,
                                 "bytes": costs[name][0], "flops": costs[name][1]}
        print(f"[bench] kernel={name} batch=64 ms={ms:.4f} wrapper_ms={wrapper_ms:.4f} "
              f"bound_ms={b_ms:.4f} bound_by={by} share={b_ms / ms:.4f} gpu={gpu!r}",
              flush=True)

    phases = {}
    for r_max in (0, 1, 8, cfg.max_region_growing_rounds):
        launch, _ = rounds_launcher(lib, x["bins"], x["mse"], x["packed"],
                                    cfg.replace(max_region_growing_rounds=r_max))
        phases[r_max] = cuda_ms(launch, args.reps, prime=True)
    report["k2_phases"] = phases
    print("[k2_phases] " + " ".join(f"r_max_{r}={ms:.4f}" for r, ms in phases.items()),
          flush=True)
    serp = depth_tensor(np.broadcast_to(serpentine_depth(480, 640, cfg.patch_size),
                                        (64, 480, 640)), dev)
    s_in = rounds_inputs(compute_cell_stats(serp, x["K"], cfg), cfg)
    s_launch, s_out = rounds_launcher(lib, *s_in, cfg)
    report["k2_serpentine"] = {"ms": cuda_ms(s_launch, args.reps, prime=True),
                               "nr_rounds": int(s_out[2][0]),
                               "planar_cells": int((s_in[2] >> 4).bool()[0].sum())}
    print(f"[k2_serpentine] batch=64 ms={report['k2_serpentine']['ms']:.4f} "
          f"nr_rounds={report['k2_serpentine']['nr_rounds']} "
          f"planar_cells={report['k2_serpentine']['planar_cells']}", flush=True)

    if args.k2_profile:
        k2_profile(x, cfg, report)
    if args.k3_profile:
        k3_profile(x, report)

    if "baseline" in libs:
        base = launchers("baseline")
        for name in base:
            (t_launch, t_outs), (b_launch, b_outs) = tree[name], base[name]
            t_launch(), b_launch()
            if name == "cell_moments":      # the alternation: run each ring once
                t_launch(), b_launch()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(t_outs, b_outs))
            turns = [cuda_ms(fn, args.reps, prime=True)
                     for fn in (b_launch, t_launch, t_launch, b_launch)]
            report["ab"][name] = {"baseline_ms": [turns[0], turns[3]],
                                  "tree_ms": [turns[1], turns[2]], "outputs_equal": equal}
            print(f"[ab] kernel={name} batch=64 baseline_ms={turns[0]:.4f},{turns[3]:.4f} "
                  f"tree_ms={turns[1]:.4f},{turns[2]:.4f} outputs_equal={equal} gpu={gpu!r}",
                  flush=True)
        if "merge_planes" not in base:      # a baseline K3 fed the adjacency
            lb = libs["baseline"]
            with_adj = assoc_merge_launcher(lb, x["labels_map"], x["segments"], cfg, True)
            without = assoc_merge_launcher(lb, x["labels_map"], x["segments"], cfg, False)
            t_launch, t_outs = tree["merge_planes"]
            t_launch(), with_adj[0](), without[0]()
            torch.cuda.synchronize()
            labels_equal, table_diff = merge_outputs_compare(t_outs, with_adj[1])
            turns = [cuda_ms(fn, args.reps, prime=True) for fn in
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
