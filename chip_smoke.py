#!/usr/bin/env python3
"""Smoke run of deplex_tpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports only numpy, torch and deplex_tpu_torch (from this checkout), and:

  1. prints the environment (torch, CUDA, nvcc, the card and its power limit);
  2. builds the CUDA kernels from deplex_tpu_torch/csrc;
  3. holds each kernel against its plain PyTorch twin on the card, at the
     main path's shapes (TUM VGA at P=10, B=8; ICL VGA at P=4, B=2; the
     points entry; a seeded batch with mixed round counts; the 720p
     primitives path's: K1's points entry at P=8 over 1280x720, K2 on a
     90x160 grid, K3 at M=32), K1's 13 planes
     bit-equal (also at P=160, its per-cell kernel); the cell-finalize
     kernel (csrc/cellfinal.cu: every CellStats field, the normal bins and
     the packed edges) bit-equal on K1's planes of every case, and the
     round-finalize kernel (csrc/rounds.cu: the round sums in their fixed
     tree order, the cell labels, every slot table) bit-equal on K2's
     outputs of every case and of K2's random graphs (with seeded cell
     statistics, up to 300x250 cells), at 2048 and 0 rounds and on a B=1
     TUM frame, each on 1, 2, 4 and 8 blocks a frame (a thread-block
     cluster) and the wrapper's choice; cell finalize also on 7x13 and
     300x250 grids and on the B=1 frame; K2 also on seeded
     random directed graphs (7x13, 48x64, 50x100, 120x160 and 300x250
     cells, MSE ties inside bins), on adversarial frames for its seed
     (+inf, NaN, -0.0 and +0.0 MSE, dead prefixes of a bin's sorted list
     longer than 32, the cell-0 fallback; 48x64, 120x160, 300x250) and on
     a serpentine wall (one winding corridor); K3 (adjacency and merge from the cell labels) also on seeded
     label maps and tables (coplanar, mixed, chained, full and edge cases on
     7x13, 48x64 and 120x160 cells, M = 8, 64, 100 and 128, so both of its
     instantiations run); times each kernel's own launch (K1 over two
     alternating rings, 78.6 MB) and its twin with CUDA events at the
     serving shape (TUM, B=64; the two finalize kernels at B=1 too),
     beside the kernel's bound on the H100
     (``tools/kernel_bench.py``; the round-finalize kernel beside the
     one-hot torch.bmm pair that computed the region sums before it, its
     library column); K1 reads the intrinsics from the card, and
     a second camera's K stays bit-equal; the stage-6 chunk-step kernel
     ([k6]: a chunk scored and the early-exit update applied in one launch)
     held bit-equal to its twin after each of the 8 chunks (the chunk's
     counts, the state, chunks scored) on [ransac]'s B=8 ring at ratios
     0.15 and 0.018 (frames stop early) and with 50 hypotheses (one chunk
     of 50), an ICL ini batch (P=4) and a 720p batch (P=8), timed at chunk
     0 beside its bound in float32 instructions; [sampling] the stage-6
     sampling kernels (csrc/sampling.cu: the merged cell labels and a stable
     counting sort of the cells by plane on a thread-block cluster a frame,
     then every hypothesis fitted and padded over the whole card, and the
     loop's first state) bit-equal to their twin on every output on the
     same ring under the default draws, a caller's (MAXP, K, 3) and (B, MAXP,
     K, 3) ranks and ranks outside the planes' pixels, at B=1, on the ICL
     and 720p (P=8 and P=4: 57,600 cells) batches, the ICL frame at P=2
     (76,800 cells), at every cluster size and on grids with empty planes,
     timed at B=8, B=1, ICL P=4 B=4 and 720p P=4 B=2 beside their bound in
     bytes and one stable torch.sort of the cell labels; the labels kernel
     (csrc/labels.cu: stage 5's pixel labels in uint8 or int32, with stage
     6's final inlier pass) bit-equal to its twin at TUM B=64 (both dtypes)
     and B=1, on an ICL batch (P=4), the 720p scene (P=8), a 475x633 crop
     (remainder strips), seeded tables of 255 and 300 planes, all-zero cell
     labels and [k6]'s B=8 winners at both ratios, timed in each dtype, at
     B=1 and in stage 6's mode beside its bound in bytes and one
     nearest-neighbour interpolate of the cell map (its library column);
  4. [stages] times each stage of the batched path on its own over a ring of
     two batches of 64 rolled TUM frames (``tools/stage_bench.py``);
     drives the main path (BatchDepthExtractor on a B=64 ring of the TUM
     frame) with the launch counters zeroed and the plain functions whose
     work kernels do on the card (``PLAIN_GLUE``: the adjacency, the cell
     finalize, normal bins, edges, region sums, round finalize, stage 5's
     rasterize and stage 6's final pass) made to raise for card tensors,
     checks every kernel ran exactly once and the result
     (34 planes, golden F1 >= 0.95); [conformance]
     (``tools/conformance.py``) holds TUM default, ICL ini and ICL default
     (BASELINE.json config 1) to their goldens (F1 >= 0.95, 34 planes on
     TUM) with the card's labels equal to the CPU twins' and K1's moment
     planes and the cell-finalize outputs bit-equal, K1 and cell finalize
     launched twice a config and K2, round finalize, K3 and the labels
     kernel once, and the
     B=64 TUM labels equal to the CPU twins'; the points and depth entries
     equal; then [e2e] times frames/s at B=64 and the B=1 p50 latency,
     each eager and captured (the entry points replay CUDA graphs,
     ``deplex_tpu_torch/compiled.py``);
  5. [ransac] drives stage 6 (the shipped RANSAC ini, B=8 TUM ring) through
     BatchDepthExtractor.process, a replay of the graph that records stages
     1-6, with the counters zeroed: the six plane kernels once (the labels
     kernel writes the refined uint8 labels), the sampling kernels' two
     launches (the sort, the fits) and the chunk-step kernel once a chunk
     (8), the labels and the chunks scored per frame equal to the
     eager loop's (the form that stops on a host check) and the labels to
     extract_depth_batch's; process_stream replays the same graph; labels
     only removed, per-plane MSE not worse; over eight seeded streams of
     draws, mean golden F1 >= 0.30 and each survivor mass within [0.4, 1.6]
     of the golden's; card labels equal to the CPU twins' under the same
     draws and under the default ones, and so do the 720p stress scene's at
     P=4 (57,600 cells); [ransac_time] stage 6 alone, the
     path eager and captured in turns, without stage 6, and runtime
     launches a call;
  6. [slam] tracks a 30-frame warped TUM sequence at 640x480 with PlaneSlam
     (counters zeroed: every kernel ran each frame), checks the ATE bounds of
     tracking, BA and the pose graph, runs the same on the CPU twins (equal
     per-frame matches, landmarks, poses within a stated bound); times.
     refine and optimize_trajectory run eagerly at their first call and
     record their CUDA graphs at their second (run_ba; the pair measurement
     and optimize_pose_graph), which [slam_time] splits into the recording
     and the rest; the second call and the replays that follow must give
     the first call's trajectories to the bit;
  7. [primitives] drives PlaneExtractor.process_primitives at 1280x720, P=8
     (tests/test_stress.py's scene and config: a cylinder in front of a
     floor and two walls) with the counters zeroed: every kernel ran, the
     test's bounds hold, card labels equal the CPU twins' and the cylinder
     parameters agree; the 240x320 cylinder scene and the TUM frame; times;
  8. [dist] two ranks on the card (gloo) through parallel.launcher and
     parallel.verify: their extraction of a B=64 ring equals one process's,
     run_ba_sharded on the [slam] BA problem is held to the dense run_ba
     with ranks' eta bit-equal, refine(mesh=...) from the [slam] checkpoint
     keeps the [slam] ATE bound; with two cards or more, the same with NCCL
     and a card a rank; times;
  9. [tf32] a caller's TF32 (set through allow_tf32, then fp32_precision):
     extract_depth_batch, PlaneSlam.process_frame and run_ba leave the
     caller's flags as they were and give the TF32-off results, and so do
     the graphs of extract_depth_batch_jit, process_frame and run_ba
     recorded under the caller's TF32 (the graph cache cleared first); refine,
     optimize_trajectory, optimize_pose_graph, run_ba_sharded,
     extract_planes_spatial, extract_primitives and stage_timings leave the
     flags as they were;
     [graphs] (``tools/graphs.py``) the nine compiled entry points against
     their eager functions: three calls each on other inputs (PlaneSlam:
     [slam]'s 30 frames; the backends run_ba, the pair measurement and
     optimize_pose_graph on its 30 keyframes, bit-equal), the eager first
     call included, labels, matches and spawns equal and poses within
     [slam_card_vs_cpu]'s bounds; a held output unchanged; N calls launch
     each kernel N times; the RANSAC ini at B=8 (stages 1-6 in one graph, 8
     scoring launches a call); two cameras record one graph; a recording made
     to fail (a host sync in a glue op, in a child process) raises and
     returns no labels; eager and captured times side by side (TUM and ICL
     P=4 at B=64, B=1, 720p primitives, process_frame, refine(10),
     optimize_trajectory()), each graph's recording time and pool bytes;
 10. [native] builds the C++ PNG16 decoder with g++ (reports g++ and the
     libz it linked), holds it bit-equal to the Python decoder on TUM, ICL
     and the TUM frame written under each PNG filter type, back-projection
     bit-equal; decode ms of both on this host;
 11. [sequence] tools/make_sequence writes [slam]'s 30 frames as PNGs;
     examples.process_sequence streams them through the native
     SequenceLoader (30 native decodes, no Python one) to the in-memory
     frames' labels, streaming and at B=8; frames/s;
 12. [slam_seq] examples.run_slam --dataset on those PNGs with the golden's
     arguments: ATE beside the golden's within [slam]'s bounds, per-frame
     matches and tracked poses equal to [slam]'s in-memory run;
 13. [slam_seq_icl] BASELINE.json config 3: tools/make_sequence writes 30
     warped ICL-NUIM frames (seed 0) and examples.run_slam --dataset tracks
     them with the ICL ini (P=4, 120x160 cells) and the golden's arguments
     (data/golden/slam_ate_icl30.json): the plane kernels once a frame, ATE within
     [slam]'s bounds beside the golden's, and the CPU twins over the first
     10 frames: equal per-frame matches, poses within [slam]'s bounds;
 14. [spatial] one frame's cell rows split over 1 and 2 gloo ranks on the
     card (``tools/spatial_bench.py`` through parallel.launcher) at 1280x720
     P=8 (the planes-only room) and on TUM: every rank's labels equal one
     process's; times per rank against one process, bytes gathered;
 15. [bench_720p] BASELINE.json config 4 (``tools/bench_720p.py``): a
     resident ring of 4 x 8 rolled 720p frames through extract_depth_batch,
     every timed call's labels within 2-16 planes and > 50% labelled;
 16. [scaling] ShardedPlaneExtractor at 1 and 2 ranks
     (``tools/scaling_report.py``): labels equal one process's; frames/s;
 17. [profiling] stage_timings' keys with and without the RANSAC ini, the
     annotate ranges in a trace of one eager B=1 depth call (a replay has
     no ranges), and that call's latency with the ranges and with annotate
     made a no-op;
 18. [wheel] ``tools/build_wheel.py`` builds the wheel (prebuilt sm_90a
     kernels and native library), pip installs it into a temporary
     directory, and a subprocess there (cwd outside the checkout, only that
     directory on PYTHONPATH, no nvcc reachable) runs
     PlaneExtractor.process_depth on the TUM frame: 34 planes, the
     checkout's labels, each plane kernel launched once, one native decode.

Every path that runs without stage 6 requires K1, cell finalize, K2, round
finalize, K3 and the labels kernel (twice on the primitives path, never on
the SLAM step, which writes no pixel labels) and no scoring launch; every
path runs inside ``no_plain_glue``. Any failed check raises, so the script exits non-zero.
The last line is a JSON object {"ok": true, "device": {...}}; the line
before it lists each kernel's launches (the six plane kernels' on the
main path, the sampling and scoring kernels' on [ransac]'s), largest absolute
difference from its twin over every output compared, times, bound and
share of the bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "data"

# Card-vs-CPU bound on the SLAM trajectory (largest absolute difference of
# any rotation entry, and of any translation in mm, over the 30 frames).
SLAM_ROTATION_TOL = 1e-5
SLAM_TRANSLATION_TOL_MM = 0.05

# Seeded streams of RANSAC draws over which the golden F1 bound is averaged.
F1_SEEDS = 8

# tests/test_stress.py's 720p config (BASELINE.json config 4) and
# tests/test_cylinder.py's 240x320 one.
HIRES = dict(patch_size=8, max_planes=32, cylinder_extraction=True,
             min_region_growing_cells_activated=3, min_region_growing_candidate_size=3,
             max_region_growing_rounds=64)
CYL240 = dict(patch_size=8, cylinder_extraction=True, max_planes=16,
              min_region_growing_cells_activated=3, min_region_growing_candidate_size=3,
              max_region_growing_rounds=64, depth_discontinuity_threshold=600.0)
# Card-vs-CPU bounds on the 720p cylinders (tests/test_torch_cylinder.py's
# port-vs-reference tolerances): axis entries up to sign, center in mm,
# radius and rmse relative (rmse also absolute).
CYL_AXIS_TOL, CYL_CENTER_TOL_MM, CYL_RADIUS_RTOL, CYL_RMSE_RTOL, CYL_RMSE_ATOL = \
    1e-4, 0.5, 1e-4, 1e-3, 1e-3

# [dist]: run_ba_sharded against the dense run_ba, tests/test_multiprocess.py's
# tolerances (rotation entries; translations and landmarks; cost).
DIST_R_ATOL, DIST_T_RTOL, DIST_T_ATOL, DIST_COST_RTOL, DIST_COST_ATOL = 1e-4, 5e-3, 0.2, 1e-2, 1e-4
# Each launch of the two ranks gets its own limit.
DIST_TIMEOUT_S = 600

# The compiled SLAM backends (``compiled`` entries).
BACKENDS = ("run_ba", "PlaneSlam.pair_measure_fn", "optimize_pose_graph")

KERNELS = {
    "cell_moments": ("deplex_tpu_torch/csrc/cellstats.cu",
                     "deplex_tpu/ops/pallas_cellstats.py:82"),
    # Stage 1's fit and gates, the normal bins and the edges: XLA fusions of
    # finalize_cell_stats, normal_bins (histogram.py:16) and
    # admissibility_edges (growing.py:152) in the JAX package; no pallas_call.
    "cell_finalize": ("deplex_tpu_torch/csrc/cellfinal.cu",
                      "deplex_tpu/ops/cellstats.py:106"),
    "grow_rounds": ("deplex_tpu_torch/csrc/growing.cu",
                    "deplex_tpu/ops/pallas_growing.py:131"),
    # The round sums, fits, gates and slots: XLA fusions of region_sums and
    # finalize_rounds (growing.py:294) in the JAX package; no pallas_call.
    "round_finalize": ("deplex_tpu_torch/csrc/rounds.cu",
                       "deplex_tpu/ops/growing.py:89"),
    "merge_planes": ("deplex_tpu_torch/csrc/merge.cu",
                     "deplex_tpu/ops/pallas_merge.py:158"),
    # Stage 5's pixel labels, the uint8 cast and stage 6's final inlier pass:
    # XLA fusions of rasterize_labels (two one-hot matmuls) and of
    # refine_labels' last where (ransac.py:325-332); no pallas_call.
    "pixel_labels": ("deplex_tpu_torch/csrc/labels.cu",
                     "deplex_tpu/ops/merge.py:156"),
    # Stage 6's sampling: the cell-grid sampling and pad_hyp, XLA fusions
    # inside refine_labels (ransac.py:105-135, :173-189); no pallas_call.
    "ransac_sampling": ("deplex_tpu_torch/csrc/sampling.cu",
                        "deplex_tpu/ops/ransac.py:105"),
    # Stage 6's chunk scoring: the JAX package leaves it to XLA (one fusion
    # of chunk_losses inside refine_labels' while_loop; no pallas_call).
    "ransac_scores": ("deplex_tpu_torch/csrc/ransac.cu",
                      "deplex_tpu/ops/ransac.py:222"),
}
# The path each kernel's "launches" is read from: K1, cell finalize, K2,
# round finalize and K3 run on the main path; the sampling and scoring
# kernels run with stage 6 only, on [ransac]'s.
LAUNCHES_FROM = {"cell_moments": "main", "cell_finalize": "main", "grow_rounds": "main",
                 "round_finalize": "main", "merge_planes": "main", "pixel_labels": "main",
                 "ransac_sampling": "ransac", "ransac_scores": "ransac"}

# The plain functions no card path may call (module of the package,
# function): stage 4 builds the adjacency in its kernel, stages 1-3's glue
# is the cell-finalize and round-finalize kernels', stage 5 and stage 6's
# final pass are the labels kernel's, and stage 6's sampling (the merged cell
# labels, the order, the hypotheses, the first state) the sampling kernel's.
PLAIN_GLUE = (("ops.merge", "plane_adjacency"), ("ops.cellstats", "finalize_cell_stats"),
              ("ops.histogram", "normal_bins"), ("ops.growing", "admissibility_edges"),
              ("ops.growing", "region_sums"), ("ops.growing", "finalize_rounds"),
              ("ops.merge", "rasterize_labels"), ("ops.ransac", "inlier_labels"),
              ("ops.merge", "apply_label_lut"), ("ops.ransac", "sample_stage_reference"),
              ("ops.ransac", "sample_hypotheses"), ("ops.ransac", "new_chunk_state"))


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def on_card(x) -> bool:
    """Whether x holds a tensor on a card (x a tensor, a tuple or list, such
    as a NamedTuple of tensors, or a dict of them)."""
    if hasattr(x, "is_cuda"):
        return bool(x.is_cuda)
    if isinstance(x, (tuple, list)):
        return any(on_card(v) for v in x)
    if isinstance(x, dict):
        return any(on_card(v) for v in x.values())
    return False


@contextlib.contextmanager
def no_plain_glue():
    """Inside, each function of PLAIN_GLUE raises when it is given card
    tensors, under every name a module of the package holds it by: on the
    card those stages are kernels, so no path may call the plain ones there
    (the CPU twins still may)."""
    import importlib

    patched = []
    for mod_name, fn_name in PLAIN_GLUE:
        original = getattr(importlib.import_module(f"deplex_tpu_torch.{mod_name}"), fn_name)

        def forbidden(*args, _original=original, _what=f"ops.{fn_name}", **kwargs):
            if on_card(args) or on_card(kwargs):
                raise AssertionError(f"{_what} ran on the card's path")
            return _original(*args, **kwargs)
        for mod in [m for n, m in sys.modules.items() if n.startswith("deplex_tpu_torch")]:
            for attr, value in list(vars(mod).items()):
                if value is original:
                    setattr(mod, attr, forbidden)
                    patched.append((mod, attr, original))
    try:
        yield
    finally:
        for mod, attr, original in reversed(patched):
            setattr(mod, attr, original)


def require_launches(launches: dict, what: str, least: int = 1, exact: bool = False,
                     labels: int | None = None) -> None:
    """A path without stage 6: each of K1, cell finalize, K2, round finalize,
    K3 and the labels kernel launched at least `least` times (exactly, with
    `exact`), the stage-6 scoring kernel never. `labels`: the labels
    kernel's exact count where it differs (twice a primitives call, never
    on the SLAM step, which writes no pixel labels). Values may be per-rank
    lists."""
    from deplex_tpu_torch.kernels import PLANE_KERNELS

    require(set(PLANE_KERNELS) <= set(launches), f"{what}: launches of {sorted(launches)}")
    for name, counts in launches.items():
        for n in (counts if isinstance(counts, list) else [counts]):
            if name not in PLANE_KERNELS:
                require(n == 0, f"{what}: stage 6's kernel {name} launched {n} times")
            elif name == "pixel_labels" and labels is not None:
                require(n == labels, f"{what}: the labels kernel launched {n} times, "
                        f"expected {labels}")
            else:
                require(n == least if exact else n >= least,
                        f"{what}: kernel {name} launched {n} times, expected "
                        f"{'' if exact else 'at least '}{least}")


def per_plane_mse(points, labels) -> dict:
    """Plane-fit MSE per label (lambda_min / n, tests/test_refinement.py)."""
    out = {}
    for pid in np.unique(labels[labels > 0]):
        pts = points[labels == pid].astype(np.float64)
        if len(pts) >= 3:
            c = pts - pts.mean(0)
            out[int(pid)] = np.linalg.eigvalsh(c.T @ c)[0] / len(pts)
    return out


def ate_mm(trajectory, poses) -> float:
    """RMS camera-centre error of a camera-from-world trajectory
    (tests/test_slam_sequence.py)."""
    errs = [np.linalg.norm(-R.T @ t - (-Rg.T @ tg)) for (R, t), (Rg, tg) in zip(trajectory, poses)]
    return float(np.sqrt(np.mean(np.square(errs))))


def ransac_ring(tum, batch: int = 8) -> np.ndarray:
    """[ransac]'s B=8 ring: the TUM frame, then frames rolled by seeded shifts."""
    rng = np.random.default_rng(1)
    shifts = [(int(rng.integers(1, 8)), int(rng.integers(1, 8))) for _ in range(batch - 1)]
    return np.stack([tum.data] + [np.roll(tum.data, s, (0, 1)) for s in shifts])


def ransac_phase(torch, dev, gpu: str, tum, K_tum, batch: int = 8, cpu_frames: int = 2) -> dict:
    """Stage 6 on the card: the shipped RANSAC ini through BatchDepthExtractor
    (``extract_depth_batch_jit``: stages 1-6 recorded as one graph, the loop
    of fixed trip count with the early exit on the device) on a ring of TUM
    frames (frame 0 unshifted), then process_stream, with its checks and
    times. Returns the path's kernel launches (the replay's)."""
    from deplex_tpu_torch import Config, kernels
    from deplex_tpu_torch.kernels import labels as k_labels
    from deplex_tpu_torch.kernels import ransac as k_ransac
    from deplex_tpu_torch.kernels import sampling as k_sampling
    from deplex_tpu_torch.ops.merge import apply_label_lut
    from deplex_tpu_torch.ops.ransac import DEFAULT_CHUNK, draw_ranks, refine_cells
    from deplex_tpu_torch.parallel.batch import (BatchDepthExtractor, depth_batch_call,
                                                 depth_batch_graph, extract_depth_batch,
                                                 extract_depth_batch_jit)
    from deplex_tpu_torch.pipeline import (backproject_device, depth_tensor, full_float32,
                                           intrinsics_tensor, plane_stages)
    from deplex_tpu_torch.tools._common import label_f1, mean_ms
    from deplex_tpu_torch.tools.profile_path import profile

    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini"))
    require(cfg.ransac_refinement, "the RANSAC ini does not enable refinement")
    coarse_cfg = cfg.replace(ransac_refinement=False)
    H, W, P = tum.height, tum.width, cfg.patch_size
    chunks = -(-cfg.ransac_max_iterations // DEFAULT_CHUNK)
    ring = ransac_ring(tum, batch)
    Kd = intrinsics_tensor(K_tum, dev)

    extractor = BatchDepthExtractor(H, W, cfg, batch=batch, device=dev)
    extractor.process(ring, K_tum)                   # the eager call, then the recording
    torch.cuda.synchronize()
    graph = depth_batch_graph(ring.shape, cfg, dev)
    require(graph is not None, "[ransac] extract_depth_batch_jit recorded no graph")
    replays = graph.replays
    kernels.reset_launch_counts()
    with no_plain_glue():
        refined = extractor.process(ring, K_tum).astype(np.int32)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    scored = graph.outputs[1].tolist()               # this replay's chunks scored per frame
    say("ransac", batch=batch, launches=launches, graph_launches=graph.launches,
        replays=graph.replays - replays, chunks_scored=scored)
    require(graph.replays - replays == 1, "[ransac] process did not replay the graph")
    for name in kernels.PLANE_KERNELS:                          # labels: the final pass
        require(launches[name] == 1, f"RANSAC path: kernel {name} launched {launches[name]}")
    require(launches["ransac_sampling"] == k_sampling.LAUNCHES_PER_CALL,
            f"RANSAC path: the sampling kernels launched {launches['ransac_sampling']} times, "
            f"expected {k_sampling.LAUNCHES_PER_CALL} (the sort and the fits)")
    require(launches["ransac_scores"] == chunks,
            f"RANSAC path: the scoring kernel launched {launches['ransac_scores']} times, "
            f"expected {chunks} (one a chunk)")

    def refine_on(planes, config, **kw):
        """Stages 5-6 of stages 1-4's `planes` as pipeline.refine_stage
        composes them (the sampling and chunk-step kernels, the labels
        kernel's final pass; their twins on the CPU), with refine_cells'
        draws= or fixed_trip=."""
        return refine_cells(
            planes.points, None, planes.labels_map, W, P, config,
            merge_labels=planes.merge_labels, sample=k_sampling.sample,
            step=k_ransac.chunk_step, **kw,
            write=lambda *w: k_labels.pixel_labels(planes.labels_map, planes.merge_labels, H,
                                                   W, P, refine=w))

    # The eager loop on the same inputs: the form that stops on a host check
    # once every frame is done, the kernel scoring each chunk, the labels
    # kernel's final pass.
    ring_dev = depth_tensor(ring, dev)
    with full_float32(dev):
        planes5 = plane_stages(ring_dev, Kd, cfg)
        eager, eager_scored = refine_on(planes5, cfg, fixed_trip=False)
    eager_fn = extract_depth_batch(ring_dev, K_tum, cfg).cpu().numpy()
    say("ransac", eager_loop_chunks_scored=eager_scored.tolist(),
        captured_vs_eager_loop_pixels=int((eager.cpu().numpy() != refined).sum()),
        captured_vs_eager_function_pixels=int((eager_fn != refined).sum()))
    require(np.array_equal(eager.cpu().numpy(), refined), "[ransac] captured labels differ "
            "from the eager loop's")
    require(np.array_equal(eager_fn, refined), "[ransac] captured labels differ from "
            "extract_depth_batch's")
    require(eager_scored.tolist() == scored, f"[ransac] chunks scored per frame {scored}, the "
            f"eager loop's {eager_scored.tolist()}")

    # The early exit on the device: at the shipped ratio (0.15, 1-unit
    # threshold) some plane of every TUM frame never reaches its target, so
    # every frame scores all 8 chunks; at a ratio of 0.018 the ring's frames
    # finish after 1 to 8 chunks, and the graph's kernel must skip the chunks
    # the eager loop skips.
    low = cfg.replace(ransac_inliers_ratio=0.018)
    low_labels, low_scored = depth_batch_call(ring_dev, Kd, low)
    low_labels, low_scored = depth_batch_call(ring_dev, Kd, low)     # the replay
    with full_float32(dev):
        low_eager, low_eager_scored = refine_on(planes5, low, fixed_trip=False)
    say("ransac", early_exit_ratio=0.018, captured_chunks_scored=low_scored.tolist(),
        eager_loop_chunks_scored=low_eager_scored.tolist(),
        labels_equal=bool(torch.equal(low_labels.to(torch.int32), low_eager)))
    require(torch.equal(low_labels.to(torch.int32), low_eager) and
            low_scored.tolist() == low_eager_scored.tolist(),
            "[ransac] ratio 0.018: captured labels or chunks scored differ from the eager loop's")
    require(min(low_scored.tolist()) < chunks, "[ransac] ratio 0.018: no frame stopped early")

    coarse = BatchDepthExtractor(H, W, coarse_cfg, batch=batch, device=dev).process(
        ring, K_tum).astype(np.int32)
    changed = refined != coarse
    require(bool((refined[changed] == 0).all()), "RANSAC changed a label to another plane")
    improved = total = 0
    for b in range(batch):
        pts = backproject_device(depth_tensor(ring[b], "cpu"), K_tum).numpy()
        mse_c, mse_r = per_plane_mse(pts, coarse[b]), per_plane_mse(pts, refined[b])
        require(bool(mse_r), f"frame {b}: refinement removed every plane")
        improved += sum(1 for p in mse_r if p in mse_c and mse_r[p] <= 1.05 * mse_c[p])
        total += len(mse_r)
    # tests/test_refinement.py: refined MSE <= 1.05 x coarse for >= 80% of planes.
    require(improved >= 0.8 * total, f"refined MSE not better on {total - improved}/{total} planes")
    say("ransac", removed_share=f"{float(changed.mean()):.4f}",
        mse_not_worse=f"{improved}/{total}")

    # process_stream replays the same graph, stage 6 included.
    batches = [ring, np.roll(ring, 1, 0), ring[::-1].copy()]
    before = graph.replays
    streamed = list(extractor.process_stream(batches, K_tum, max_in_flight=2))
    require(graph.replays - before == len(batches), f"[ransac] process_stream replayed "
            f"{graph.replays - before} times for {len(batches)} batches")
    require(all(np.array_equal(o.astype(np.int32), extractor.process(b, K_tum).astype(np.int32))
                for b, o in zip(batches, streamed)), "[ransac] process_stream labels differ")
    require(np.array_equal(streamed[0].astype(np.int32), refined),
            "[ransac] process_stream's first batch differs from process")
    say("ransac", stream_batches=len(batches), stream_replays=graph.replays - before)

    def stages_1_to_4(depth, device):
        """One frame's PlaneCells (cell labels, merge labels, points),
        stages 1-4 on `device`."""
        with full_float32(device):
            return plane_stages(depth_tensor(depth[None], device),
                                intrinsics_tensor(K_tum, device), cfg)

    def seeded_draws(planes, seed):
        """Draws of a CPU generator seeded `seed`, on the cell labels' device."""
        cell_labels = apply_label_lut(planes.labels_map, planes.merge_labels)
        counts = torch.bincount(cell_labels.reshape(-1).long(), minlength=cfg.max_planes + 1)
        return draw_ranks(counts[1:] * P * P, cfg.ransac_max_iterations,
                          torch.Generator().manual_seed(seed))

    def refine(frame, draws=None):
        """Stages 5-6 of one frame's stages 1-4."""
        return refine_on(frame, cfg, draws=draws)[0][0]

    # Golden bounds on frame 0 over seeded streams of draws (seed 0 is the
    # default stream): at the 1-unit threshold one stream's F1 is noise around
    # 0.30, so the bound holds on the mean; the mass bound holds on each.
    gold = np.load(DATA / "golden" / "tum_ransac_labels.npz")["labels"]
    kept_gold = int((gold > 0).sum())
    frame0 = stages_1_to_4(ring[0], dev)
    f1s, masses = [], []
    for seed in range(F1_SEEDS):
        got = refine(frame0, seeded_draws(frame0, seed)).cpu().numpy()
        if seed == 0:
            require(np.array_equal(got, refined[0]), "seed-0 draws differ from the default stream")
        f1s.append(label_f1(got, gold))
        masses.append(int((got > 0).sum()) / kept_gold)
    say("ransac", frame=0, seeds=F1_SEEDS, golden_f1_mean=f"{np.mean(f1s):.4f}",
        golden_f1_default=f"{f1s[0]:.4f}", golden_f1_min=f"{min(f1s):.4f}",
        golden_f1_max=f"{max(f1s):.4f}", mass_ratio_min=f"{min(masses):.4f}",
        mass_ratio_max=f"{max(masses):.4f}", kept_golden=kept_gold)
    require(np.mean(f1s) >= 0.30, f"RANSAC golden F1 mean {np.mean(f1s)} over {F1_SEEDS} seeds")
    require(all(0.4 <= m <= 1.6 for m in masses), f"RANSAC mass ratios {masses}")

    # The card against the CPU twins, fed the same draws: the same labels;
    # with the default draws, the captured labels equal the CPU's.
    for b in range(cpu_frames):
        card, cpu = stages_1_to_4(ring[b], dev), stages_1_to_4(ring[b], "cpu")
        for what, x, y in zip(card._fields, card, cpu):
            require(torch.equal(x.cpu(), y), f"frame {b}: stage 1-4 {what} differ card vs CPU")
        draws = seeded_draws(cpu, b)
        got, ref = refine(card, draws.to(dev)), refine(cpu, draws)
        differing = int((got.cpu() != ref).sum())
        default_cpu = refine(cpu)
        default_differing = int((torch.from_numpy(refined[b]) != default_cpu).sum())
        say("ransac_card_vs_cpu", frame=b, pixels_differing=differing,
            default_draws_pixels_differing=default_differing, kept=int((ref > 0).sum()))
        require(differing == 0, f"frame {b}: card RANSAC labels differ from the CPU's")
        require(default_differing == 0, f"frame {b}: default-draw labels differ card vs CPU")

    # The 720p stress scene at P=4 (180x320 = 57,600 cells, a grid the one-launch
    # sampling kernel refused) end to end, card against CPU: stages 1-4 and
    # stage 6's labels under the default draws, and stage 6 alone on the
    # card's stages 1-4 copied to the CPU.
    from deplex_tpu_torch.tools.kernel_bench import stress720_p4_config
    from deplex_tpu_torch.utils.scenes import hires_scene
    hi_pts, hi_h, hi_w = hires_scene()
    cfg_hi = stress720_p4_config(cfg)

    def hi_stages(device):
        with full_float32(device):
            return plane_stages(torch.as_tensor(hi_pts, device=device).reshape(
                1, hi_h, hi_w, 3).contiguous(), None, cfg_hi)

    def hi_refine(planes):
        with full_float32(planes.points.device):
            return refine_cells(
                planes.points, None, planes.labels_map, hi_w, cfg_hi.patch_size, cfg_hi,
                merge_labels=planes.merge_labels, sample=k_sampling.sample,
                step=k_ransac.chunk_step,
                write=lambda *w: k_labels.pixel_labels(planes.labels_map, planes.merge_labels,
                                                       hi_h, hi_w, cfg_hi.patch_size,
                                                       refine=w))[0][0]

    kernels.reset_launch_counts()
    hi_card = hi_stages(dev)
    got = hi_refine(hi_card)
    torch.cuda.synchronize()
    hi_launches = kernels.launch_counts()
    hi_cpu = hi_stages("cpu")
    stages_equal = all(torch.equal(x.cpu(), y) for x, y in zip(hi_card, hi_cpu))
    ref = hi_refine(hi_cpu)
    same_inputs = hi_refine(type(hi_card)(*(t.cpu() for t in hi_card)))
    say("ransac_card_vs_cpu", frame="stress720_p4", grid=f"{hi_h // 4}x{hi_w // 4}",
        stages_1_4_equal=stages_equal, pixels_differing=int((got.cpu() != ref).sum()),
        pixels_differing_same_stages=int((got.cpu() != same_inputs).sum()),
        kept=int((ref > 0).sum()), labelled=int((hi_cpu.labels_map > 0).sum()) * 16,
        launches=hi_launches)
    require(hi_launches["ransac_sampling"] == k_sampling.LAUNCHES_PER_CALL,
            "stress720_p4: the sampling kernels did not run")
    require(bool((got > 0).any()), "stress720_p4: stage 6 kept no pixel")
    require(stages_equal and torch.equal(got.cpu(), ref) and torch.equal(got.cpu(), same_inputs),
            "stress720_p4: card RANSAC labels differ from the CPU's")

    # Times: stage 6 alone (the kernel loop), the path eager and captured in
    # turns, the path without stage 6; runtime launches a call.
    refine_ms = mean_ms(lambda: refine_on(planes5, cfg), reps=10, warmup=2)
    turns = {"eager": [], "captured": []}
    for side in ("eager", "captured", "captured", "eager"):
        call = (lambda: extract_depth_batch(ring_dev, Kd, cfg)) if side == "eager" else \
            (lambda: extract_depth_batch_jit(ring_dev, Kd, config=cfg))
        turns[side].append(mean_ms(call, reps=10, warmup=2))
    coarse_ms = mean_ms(lambda: extract_depth_batch(ring_dev, Kd, coarse_cfg), reps=10, warmup=2)
    low_ms = mean_ms(lambda: depth_batch_call(ring_dev, Kd, low), reps=10, warmup=2)
    rows = {side: profile(call, calls=3) for side, call in (
        ("eager", lambda: extract_depth_batch(ring_dev, Kd, cfg)),
        ("captured", lambda: extract_depth_batch_jit(ring_dev, Kd, config=cfg)))}
    say("ransac_time", batch=batch, refine_ms=f"{refine_ms:.3f}",
        path_eager_ms=",".join(f"{t:.3f}" for t in turns["eager"]),
        path_captured_ms=",".join(f"{t:.3f}" for t in turns["captured"]),
        path_without_ransac_eager_ms=f"{coarse_ms:.3f}",
        path_captured_ms_ratio_0_018=f"{low_ms:.3f}", chunks_scored_ratio_0_018=sum(
            low_scored.tolist()),
        runtime_launches_per_call_eager=rows["eager"]["runtime_launches_per_call"],
        runtime_launches_per_call_captured=rows["captured"]["runtime_launches_per_call"],
        device_busy_ms_eager=f"{rows['eager']['device_busy_ms_per_call']:.3f}",
        device_busy_ms_captured=f"{rows['captured']['device_busy_ms_per_call']:.3f}",
        graph_pool_bytes=graph.pool_bytes, graph_capture_s=f"{graph.capture_s:.4f}",
        gpu=repr(gpu))
    return launches


def slam_phase(torch, dev, gpu: str, tum, K_tum, work: pathlib.Path, frames: int = 30):
    """PlaneSlam on the card over a warped TUM sequence at 640x480 (the
    committed golden's run, data/golden/slam_ate_tum30.json), with the same
    run on the CPU twins beside it. The tracked state and its BA problem
    are saved under `work` for [dist]. Returns the path's kernel launches
    and what [dist] needs."""
    from deplex_tpu_torch import Config, PlaneSlam, compiled, kernels
    from deplex_tpu_torch.parallel.verify import write_slam_job
    from deplex_tpu_torch.pipeline import backproject_device, depth_tensor
    from deplex_tpu_torch.utils.warp import render_sequence, smooth_trajectory

    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini"))
    H, W = tum.height, tum.width
    K = np.asarray(K_tum, np.float32)
    poses = smooth_trajectory(frames, seed=0)
    seq = [np.clip(np.round(d), 0, 65535).astype(np.uint16)
           for d in render_sequence(tum.data, K, poses)]
    Kt = torch.as_tensor(K)
    golden = json.loads((DATA / "golden" / "slam_ate_tum30.json").read_text())

    def track(device):
        slam = PlaneSlam(H, W, cfg, max_landmarks=128, odom_iterations=10, device=device)
        counts, ms = [], []
        for depth in seq:
            t0 = time.perf_counter()
            res = slam.process_frame(backproject_device(depth_tensor(depth, device), Kt))
            counts.append((int(res.num_matched), int(res.num_new)))
            ms.append(1e3 * (time.perf_counter() - t0))
        return slam, counts, ms

    kernels.reset_launch_counts()
    with no_plain_glue():
        slam, counts, frame_ms = track(dev)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("slam", frames=frames, launches=launches)
    require_launches(launches, "SLAM path", least=frames, labels=0)

    tracked, tracked_map = list(slam.trajectory), slam.map
    ate_track = ate_mm(slam.trajectory, poses)
    write_slam_job(str(work / "slam"), slam)
    problem = slam.build_ba_problem()
    np.savez(work / "slam_ba.npz", **{f: v.cpu().numpy() for f, v in problem._asdict().items()
                                      if v is not None})
    def timed(call):
        """(ms of call(), ms of the graphs it recorded, entries it recorded)."""
        before = {id(g) for g in compiled.graphs()}
        t0 = time.perf_counter()
        call()
        ms = 1e3 * (time.perf_counter() - t0)
        new = [g for g in compiled.graphs() if id(g) not in before]
        return ms, 1e3 * sum(g.capture_s for g in new), sorted(g.key[0] for g in new)

    # The first call of each backend runs eagerly and records nothing; the
    # second, from the same state, records its graphs and replays them, and
    # the later ones replay: each must land on the first call's trajectory
    # to the bit.
    refine_ms, _, refine_new = timed(lambda: slam.refine(iterations=10))
    refine_ms, refine_rec_ms = [refine_ms], []
    ba_traj = list(slam.trajectory)
    ate_ba = ate_mm(slam.trajectory, poses)
    slam.trajectory, slam.map = list(tracked), tracked_map
    pg_ms, _, pg_new = timed(slam.optimize_trajectory)
    pg_ms, pg_rec_ms = [pg_ms], []
    pg_traj = list(slam.trajectory)
    ate_pg = ate_mm(slam.trajectory, poses)
    require(refine_new == [] and pg_new == [],
            f"[slam] a backend's first call recorded {refine_new + pg_new}")
    for i in range(3):                               # the recording, then replays
        slam.trajectory, slam.map = list(tracked), tracked_map
        ms, rec_ms, new = timed(lambda: slam.refine(iterations=10))
        refine_ms.append(ms)
        refine_rec_ms.append(rec_ms)
        require(new == (["run_ba"] if i == 0 else []),
                f"[slam] refine's call {i + 2} recorded {new}")
        require(same_trajectory(slam.trajectory, ba_traj) and ate_mm(slam.trajectory, poses)
                == ate_ba, "[slam] a replayed refine left another trajectory than its first call")
        slam.trajectory = list(tracked)
        ms, rec_ms, new = timed(slam.optimize_trajectory)
        pg_ms.append(ms)
        pg_rec_ms.append(rec_ms)
        require(new == (["PlaneSlam.pair_measure_fn", "optimize_pose_graph"] if i == 0 else []),
                f"[slam] optimize_trajectory's call {i + 2} recorded {new}")
        require(same_trajectory(slam.trajectory, pg_traj) and ate_mm(slam.trajectory, poses)
                == ate_pg, "[slam] a replayed optimize_trajectory left another trajectory")
    ref_ate = golden["ate_rmse_mm"]
    landmarks = int(tracked_map.count)
    say("slam", ate_tracking_mm=f"{ate_track:.3f}", ate_ba_mm=f"{ate_ba:.3f}",
        ate_pose_graph_mm=f"{ate_pg:.3f}", landmarks=landmarks,
        golden=f"{ref_ate['tracking']}/{ref_ate['ba']}/{ref_ate['pose_graph']}mm,"
               f"{golden['landmarks']}landmarks")
    require(len(slam.trajectory) == frames, "trajectory length")
    require(ate_track < 300.0, f"tracking ATE {ate_track} mm")
    require(ate_ba <= 1.05 * ate_track, f"BA ATE {ate_ba} > 1.05 x tracking {ate_track}")
    require(ate_pg <= 1.05 * ate_track, f"pose-graph ATE {ate_pg} > 1.05 x tracking {ate_track}")

    # The same sequence on the CPU twins: the same matches, frame by frame.
    cpu, cpu_counts, _ = track("cpu")
    dR = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(tracked, cpu.trajectory))
    dt = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(tracked, cpu.trajectory))
    say("slam_card_vs_cpu", frames_equal=sum(a == b for a, b in zip(counts, cpu_counts)),
        landmarks_card=landmarks, landmarks_cpu=int(cpu.map.count),
        max_rotation_diff=f"{dR:.3e}", max_translation_diff_mm=f"{dt:.3e}")
    require(counts == cpu_counts, f"per-frame (matched, new) differ: {counts} vs {cpu_counts}")
    require(landmarks == int(cpu.map.count), "landmark counts differ card vs CPU")
    require(dR <= SLAM_ROTATION_TOL and dt <= SLAM_TRANSLATION_TOL_MM,
            f"card poses off the CPU's by {dR} (rotation) / {dt} mm")
    say("slam_time", process_frame_p50_ms=f"{float(np.median(frame_ms)):.3f}",
        refine10_ms=f"{min(refine_ms[2:]):.3f}", refine10_first_eager_ms=f"{refine_ms[0]:.3f}",
        refine10_second_ms=f"{refine_ms[1]:.3f}",
        refine10_second_recording_ms=f"{refine_rec_ms[0]:.3f}",
        optimize_trajectory_ms=f"{min(pg_ms[2:]):.3f}",
        optimize_first_eager_ms=f"{pg_ms[0]:.3f}", optimize_second_ms=f"{pg_ms[1]:.3f}",
        optimize_second_recording_ms=f"{pg_rec_ms[0]:.3f}", replays_bit_equal=True,
        gpu=repr(gpu))
    return launches, {"job": work / "slam", "ba": work / "slam_ba.npz", "problem": problem,
                      "poses": poses, "ate_tracking": ate_track, "ate_ba": ate_ba,
                      "refine10_ms": min(refine_ms[2:]), "counts": counts, "tracked": tracked,
                      "frames": seq}


def same_trajectory(a, b) -> bool:
    """Two trajectories of (R, t) equal to the bit."""
    return len(a) == len(b) and all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                                    for x, y in zip(a, b))


def primitives_phase(torch, dev, gpu: str, tum, K_tum) -> dict:
    """Planes and cylinders on the card: tests/test_stress.py's 720p scene
    and config through PlaneExtractor.process_primitives, against the CPU
    twins; tests/test_cylinder.py's 240x320 scene; the TUM frame. Returns
    the 720p path's kernel launches."""
    from deplex_tpu_torch import Config, PlaneExtractor, kernels
    from deplex_tpu_torch.ops.cylinder import extract_cylinders
    from deplex_tpu_torch.pipeline import compute_cells, grow_regions
    from deplex_tpu_torch.tools._common import mean_ms
    from deplex_tpu_torch.utils.scenes import cylinder_scene, hires_scene

    pts, H, W = hires_scene()
    cfg = Config(**HIRES)
    card = PlaneExtractor(H, W, cfg, device=dev)
    card.process_primitives(pts)                     # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with no_plain_glue():
        out = card.process_primitives(pts)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("primitives", shape=f"{W}x{H}", patch=cfg.patch_size, max_planes=cfg.max_planes,
        launches=launches)
    require_launches(launches, "primitives path", labels=2)

    # tests/test_stress.py's bounds.
    cyl, plane = out["cylinders"], out["plane_labels"]
    n = int(cyl.nr_cylinders)
    i = int(np.argmax(cyl.size[:n])) if n else 0
    cyl_px = int((out["cylinder_labels"] > 0).sum())
    planes = int(np.unique(plane[plane > 0]).size)
    covered = float((plane > 0).mean())
    say("primitives", cylinders=n, radius=f"{float(cyl.radius[i]):.3f}",
        axis=np.round(cyl.axis[i], 5).tolist(), cylinder_pixels=cyl_px, planes=planes,
        plane_cover=f"{covered:.4f}")
    require(n >= 1, "720p: no cylinder found")
    require(abs(float(cyl.radius[i]) - 400.0) / 400.0 < 0.1, f"720p radius {cyl.radius[i]}")
    require(cyl_px > 2000, f"720p: {cyl_px} cylinder pixels")
    require(planes >= 2 and covered > 0.35, f"720p: {planes} planes covering {covered}")

    # The same scene on the CPU twins: the same labels, the same cylinders.
    cpu = PlaneExtractor(H, W, cfg, device="cpu").process_primitives(pts)
    differing = {k: int((out[k] != cpu[k]).sum()) for k in ("plane_labels", "cylinder_labels")}
    c2 = cpu["cylinders"]
    require(int(c2.nr_cylinders) == n, f"card {n} cylinders, CPU {int(c2.nr_cylinders)}")
    sign = np.sign(np.einsum("ci,ci->c", cyl.axis[:n], c2.axis[:n]))[:, None]
    diffs = {"axis": float(np.abs(sign * cyl.axis[:n] - c2.axis[:n]).max(initial=0)),
             "center_mm": float(np.abs(cyl.center[:n] - c2.center[:n]).max(initial=0)),
             "radius_rel": float((np.abs(cyl.radius[:n] - c2.radius[:n])
                                  / c2.radius[:n]).max(initial=0)),
             "rmse": float(np.abs(cyl.rmse[:n] - c2.rmse[:n]).max(initial=0))}
    say("primitives_card_vs_cpu", **{f"{k}_pixels_differing": v for k, v in differing.items()},
        **{f"max_{k}_diff": f"{v:.3e}" for k, v in diffs.items()})
    require(not any(differing.values()), f"720p card labels differ from the CPU's: {differing}")
    require(np.array_equal(cyl.size, c2.size), "cylinder sizes differ card vs CPU")
    require(diffs["axis"] <= CYL_AXIS_TOL and diffs["center_mm"] <= CYL_CENTER_TOL_MM
            and diffs["radius_rel"] <= CYL_RADIUS_RTOL and bool(np.all(
                np.abs(cyl.rmse - c2.rmse) <= CYL_RMSE_ATOL + CYL_RMSE_RTOL * np.abs(c2.rmse))),
            f"cylinder parameters differ card vs CPU: {diffs}")

    # tests/test_cylinder.py: the 240x320 scene, and the TUM frame.
    p240, h240, w240 = cylinder_scene()
    o240 = PlaneExtractor(h240, w240, Config(**CYL240), device=dev).process_primitives(p240)
    c240 = o240["cylinders"]
    n240 = int(c240.nr_cylinders)
    j = int(np.argmax(c240.size[:n240])) if n240 else 0
    o_tum = PlaneExtractor(tum.height, tum.width, Config(), device=dev).process_primitives(
        tum.transform_to_pcd(K_tum))
    n_tum = int(o_tum["cylinders"].nr_cylinders)
    say("primitives", scene="cylinder_240x320", cylinders=n240,
        radius=f"{float(c240.radius[j]):.3f}", axis_x=f"{float(c240.axis[j][0]):.6f}",
        tum_cylinders=n_tum)
    require(n240 >= 1 and abs(float(c240.radius[j]) - 400.0) / 400.0 < 0.08,
            f"240x320: {n240} cylinders, radius {float(c240.radius[j])}")
    require(abs(float(c240.axis[j][0])) > 0.98, f"240x320 axis {c240.axis[j]}")
    require(n_tum <= 3, f"TUM: {n_tum} cylinders")

    # Times at 720p: user calls (host points in, host labels out) and the
    # cylinder stage alone on the card.
    def p50_ms(fn, reps=15):
        fn()
        lat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            lat.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(lat))
    planes_only = PlaneExtractor(H, W, cfg, device=dev)
    pts_t = torch.as_tensor(pts, device=dev).reshape(1, H, W, 3).contiguous()
    cells = compute_cells(pts_t, None, cfg)
    rounds = grow_regions(cells, cfg)[0]
    stage_ms = mean_ms(lambda: extract_cylinders(cells.stats, rounds, cfg), 20, 3)
    say("primitives_time", shape=f"{W}x{H}",
        process_primitives_p50_ms=f"{p50_ms(lambda: card.process_primitives(pts)):.3f}",
        process_p50_ms=f"{p50_ms(lambda: planes_only.process(pts)):.3f}",
        cylinder_stage_ms=f"{stage_ms:.4f}",
        gpu=repr(gpu))
    return launches


def dist_phase(torch, dev, gpu: str, tum, K_tum, slam: dict, work: pathlib.Path) -> dict:
    """Two ranks of parallel.verify through parallel.launcher, each on card
    LOCAL_RANK % device_count: on one card, gloo (NCCL refuses two ranks on
    one device); with two cards or more, NCCL as well. Held to this single
    process on the same inputs. Returns the kernel launches summed over the
    gloo run's ranks."""
    from deplex_tpu_torch import Config
    from deplex_tpu_torch.parallel.batch import BatchPlaneExtractor, extract_depth_batch
    from deplex_tpu_torch.parallel.launcher import launch
    from deplex_tpu_torch.parallel.verify import load_rank_outputs
    from deplex_tpu_torch.pipeline import depth_tensor
    from deplex_tpu_torch.slam.ba import run_ba
    from deplex_tpu_torch.tools._common import mean_ms
    from deplex_tpu_torch.utils.depth_image import backproject

    B, H, W = 64, tum.height, tum.width
    rng = np.random.default_rng(2)
    ring = np.stack([np.roll(tum.data, (int(rng.integers(0, 8)), int(rng.integers(0, 8))),
                             (0, 1)) for _ in range(B)])
    cfg = Config()
    np.savez(work / "ring.npz", depth=ring, K=np.asarray(K_tum, np.float32),
             config=json.dumps(dataclasses.asdict(cfg)))
    ring_dev = depth_tensor(ring, dev)
    single = extract_depth_batch(ring_dev, K_tum, cfg).cpu().numpy()
    clouds = np.stack([backproject(d, K_tum) for d in ring])
    single_points = BatchPlaneExtractor(H, W, cfg, device=dev).process(clouds)
    dense = run_ba(slam["problem"], iterations=10)
    dense_R, dense_t = dense.R.cpu().numpy(), dense.t.cpu().numpy()
    dense_eta, dense_cost = dense.eta.cpu().numpy(), float(dense.cost)
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}

    def two_ranks(backend: str) -> dict:
        out = work / f"dist_{backend}"
        t0 = time.perf_counter()
        launch([sys.executable, "-m", "deplex_tpu_torch.parallel.verify", "--out", str(out),
                "--depth", str(work / "ring.npz"), "--ba-problem", str(slam["ba"]),
                "--ba-iterations", "10", "--slam-checkpoint", str(slam["job"]),
                "--refine-iterations", "10", "--time-reps", "3"],
               2, device="cuda", backend=backend, extra_env=env, timeout=DIST_TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        ranks = load_rank_outputs(out, 2)
        devices = [str(o["device"]) for o in ranks]
        launches = {k: [int(o[f"launches_{k}"]) for o in ranks] for k in KERNELS}
        say("dist", backend=backend, ranks=2, devices=devices, launches=launches,
            wall_s=f"{wall_s:.1f}")
        require(not any(bool(o["jax_imported"]) for o in ranks), "a rank imported jax")
        require_launches(launches, "[dist]")

        # Extraction: no collective, so exactly one process's labels.
        idx = np.concatenate([o["frame_idx"] for o in ranks])
        labels = np.concatenate([o["labels"] for o in ranks])
        require(idx.tolist() == list(range(B)), f"frames by rank {idx.tolist()}")
        differing = int((labels != single).sum())
        points_differing = max(int((o["points_labels"] != single_points).sum()) for o in ranks)
        # BA: run_ba_sharded against the dense run_ba, to Gauss-Newton accuracy.
        err = {"R": max(float(np.abs(o["lm_R"] - dense_R).max()) for o in ranks),
               "t": max(float((np.abs(o["lm_t"] - dense_t)
                               - DIST_T_RTOL * np.abs(dense_t)).max()) for o in ranks),
               "eta": max(float((np.abs(o["lm_eta"] - dense_eta)
                                 - DIST_T_RTOL * np.abs(dense_eta)).max()) for o in ranks),
               "cost": max(abs(float(o["lm_cost"]) - dense_cost) for o in ranks)}
        eta_equal = np.array_equal(ranks[0]["lm_eta"], ranks[1]["lm_eta"])
        traj = list(zip(ranks[0]["refine_R"], ranks[0]["refine_t"]))
        ate_sharded = ate_mm(traj, slam["poses"])
        say("dist_check", backend=backend, pixels_differing=differing,
            points_pixels_differing=points_differing, ba_max_R_diff=f"{err['R']:.3e}",
            ba_t_excess_mm=f"{err['t']:.3e}", ba_eta_excess=f"{err['eta']:.3e}",
            ba_cost_rel_diff=f"{err['cost'] / abs(dense_cost):.3e}", eta_bit_equal=eta_equal,
            ate_refine_sharded_mm=f"{ate_sharded:.3f}",
            ate_refine_dense_mm=f"{slam['ate_ba']:.3f}",
            ate_tracking_mm=f"{slam['ate_tracking']:.3f}")
        require(differing == 0, f"[dist] {backend}: {differing} pixels differ from one process")
        require(points_differing == 0, f"[dist] {backend}: ShardedPlaneExtractor labels differ")
        require(err["R"] <= DIST_R_ATOL and err["t"] <= DIST_T_ATOL
                and err["eta"] <= DIST_T_ATOL
                and err["cost"] <= DIST_COST_ATOL + DIST_COST_RTOL * abs(dense_cost),
                f"[dist] {backend}: run_ba_sharded off the dense run_ba: {err}")
        require(eta_equal and np.array_equal(ranks[0]["lm_R"], ranks[1]["lm_R"]),
                f"[dist] {backend}: ranks' BA results are not bit-equal")
        require(ate_sharded <= 1.05 * slam["ate_tracking"],
                f"sharded refine ATE {ate_sharded} > 1.05 x tracking {slam['ate_tracking']}")
        say("dist_time", backend=backend, frames_per_rank=B // 2,
            extract_ms_by_rank=[f"{float(o['extract_ms']):.3f}" for o in ranks],
            run_ba_sharded10_ms=f"{max(float(o['ba_ms']) for o in ranks):.3f}",
            refine10_sharded_ms=f"{max(float(o['refine_ms']) for o in ranks):.3f}",
            gpu=repr(gpu))
        return {k: sum(v) for k, v in launches.items()}

    launches = two_ranks("gloo")
    t0 = time.perf_counter()
    run_ba(slam["problem"], iterations=10)
    torch.cuda.synchronize()
    say("dist_time", backend="single_process", frames=B,
        extract_ms=f"{mean_ms(lambda: extract_depth_batch(ring_dev, K_tum, cfg), 5, 1):.3f}",
        run_ba10_ms=f"{1e3 * (time.perf_counter() - t0):.3f}",
        refine10_ms=f"{slam['refine10_ms']:.3f}", gpu=repr(gpu))
    if torch.cuda.device_count() >= 2:
        two_ranks("nccl")
    else:
        say("dist", nccl="not_run_one_card", device_count=torch.cuda.device_count())
    return launches


@contextlib.contextmanager
def caller_tf32(torch, how: str):
    """A caller's TF32 setting inside (``allow_tf32``: the legacy flags;
    ``fp32_precision``: the per-backend API), this process's defaults after."""
    b = torch.backends
    defaults = [s.fp32_precision for s in (b.cuda.matmul, b.cudnn.conv)]
    if how == "allow_tf32":
        b.cuda.matmul.allow_tf32 = True
        b.cudnn.allow_tf32 = True
    else:
        b.cuda.matmul.fp32_precision = "tf32"
        b.cudnn.conv.fp32_precision = "tf32"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision("highest")
        b.cudnn.allow_tf32 = True
        b.cuda.matmul.fp32_precision, b.cudnn.conv.fp32_precision = defaults


def tf32_flags(torch) -> dict:
    """What the caller reads back through both APIs (a refused read counts)."""
    b = torch.backends

    def read(getter):
        try:
            return getter()
        except RuntimeError:
            return "refused"
    return {"matmul_allow_tf32": read(lambda: b.cuda.matmul.allow_tf32),
            "cudnn_allow_tf32": read(lambda: b.cudnn.allow_tf32),
            "matmul_fp32_precision": b.cuda.matmul.fp32_precision,
            "conv_fp32_precision": b.cudnn.conv.fp32_precision,
            "float32_matmul_precision": read(torch.get_float32_matmul_precision)}


def tf32_phase(torch, dev, tum, K_tum, slam: dict, frames: int = 3) -> None:
    """[tf32]: the entry points under a caller's TF32 leave its flags as they
    were; extract_depth_batch, PlaneSlam.process_frame and run_ba also give
    the TF32-off results (they run without TF32 inside), and so do
    extract_depth_batch_jit, process_frame's graph and run_ba's when they are
    recorded under the caller's TF32 (the cache is cleared first). The other entry
    points (refine, optimize_trajectory, optimize_pose_graph, run_ba_sharded
    and extract_planes_spatial in a gloo group of one, extract_primitives,
    stage_timings) are held to the flags only."""
    import torch.distributed as tdist

    from deplex_tpu_torch import Config, PlaneSlam, compiled
    from deplex_tpu_torch.parallel.batch import extract_depth_batch, extract_depth_batch_jit
    from deplex_tpu_torch.parallel.distributed import make_mesh
    from deplex_tpu_torch.parallel.spatial import extract_planes_spatial
    from deplex_tpu_torch.pipeline import backproject_device, depth_tensor, extract_primitives
    from deplex_tpu_torch.profiling import stage_timings
    from deplex_tpu_torch.slam.ba import run_ba, run_ba_sharded
    from deplex_tpu_torch.slam.pose_graph import optimize_pose_graph

    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini"))
    rng = np.random.default_rng(3)
    ring = depth_tensor(np.stack([np.roll(tum.data, tuple(rng.integers(0, 8, 2)), (0, 1))
                                  for _ in range(8)]), dev)
    Kt = torch.as_tensor(np.asarray(K_tum, np.float32))
    pts = torch.as_tensor(tum.transform_to_pcd(K_tum), dtype=torch.float32, device=dev)
    size = dict(image_height=tum.height, image_width=tum.width)

    def run_all():
        labels = extract_depth_batch(ring, K_tum, cfg).cpu()
        # The compiled entry: recorded at its first call (under the caller's
        # flags, when the cache was cleared), replayed at the second.
        compiled_labels = [extract_depth_batch_jit(ring, K_tum, config=cfg).cpu()
                           for _ in range(2)]
        tracker = PlaneSlam(tum.height, tum.width, cfg, max_landmarks=128, odom_iterations=10,
                            device=dev)
        steps = []
        for depth in slam["frames"][:frames]:
            res = tracker.process_frame(backproject_device(depth_tensor(depth, dev), Kt))
            steps.append((int(res.num_matched), int(res.num_new)))
        # run_ba runs eagerly at its first call and records its graph at the
        # second, whose result is the replay's.
        ba = [run_ba(slam["problem"], iterations=10) for _ in range(2)][-1]
        return (labels, steps, list(tracker.trajectory), ba.R.cpu().numpy(), tracker,
                compiled_labels)

    def flags_only(tracker) -> dict:
        return {
            "PlaneSlam.refine": lambda: tracker.refine(iterations=2),
            "PlaneSlam.optimize_trajectory": lambda: tracker.optimize_trajectory(min_shared=1),
            "optimize_pose_graph": lambda: optimize_pose_graph(
                tracker.build_pose_graph(min_shared=1), iterations=2),
            "run_ba_sharded": lambda: run_ba_sharded(slam["problem"], iterations=2),
            "extract_planes_spatial": lambda: extract_planes_spatial(
                pts, **size, config=Config(), mesh=make_mesh("space"), device=dev),
            "extract_primitives": lambda: extract_primitives(
                pts, **size, config=Config(cylinder_extraction=True)),
            "stage_timings": lambda: stage_timings(pts, tum.height, tum.width, cfg,
                                                   repeats=1, device=dev),
        }

    ref = run_all()
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        for how in ("allow_tf32", "fp32_precision"):
            with caller_tf32(torch, how):
                before = tf32_flags(torch)
                # Every graph of run_all is recorded under the caller's TF32.
                compiled.clear()
                labels, steps, traj, ba_R, tracker, compiled_labels = run_all()
                recorded = len(compiled.graphs())
                after = tf32_flags(torch)
                changed = []
                for name, call in flags_only(tracker).items():
                    call()
                    if tf32_flags(torch) != before:
                        changed.append(name)
            pose_diff = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(traj, ref[2]))
            ba_diff = float(np.abs(ba_R - ref[3]).max())
            say("tf32", caller=how, flags_before=before, flags_after=after,
                labels_equal=bool(torch.equal(labels, ref[0])), matches_equal=steps == ref[1],
                max_pose_rotation_diff=f"{pose_diff:.3e}", ba_max_rotation_diff=f"{ba_diff:.3e}",
                flags_only_entry_points=len(flags_only(tracker)), flags_changed_by=changed,
                graphs_recorded=recorded,
                compiled_labels_equal=all(torch.equal(c, ref[0].to(torch.uint8))
                                          for c in compiled_labels))
            require(after == before,
                    f"[tf32] {how}: the caller's flags changed: {before} -> {after}")
            require(not changed, f"[tf32] {how}: {changed} changed the caller's flags")
            require(before["matmul_fp32_precision"] == "tf32",
                    f"[tf32] {how}: the caller's TF32 did not take: {before}")
            require(torch.equal(labels, ref[0]), f"[tf32] {how}: labels differ from TF32 off")
            require(recorded == 3, f"[tf32] {how}: {recorded} graphs recorded, expected the "
                    "batch's, PlaneSlam's and run_ba's")
            require(all(torch.equal(c, ref[0].to(torch.uint8)) for c in compiled_labels),
                    f"[tf32] {how}: a graph recorded under the caller's TF32 gives other labels")
            require(steps == ref[1], f"[tf32] {how}: per-frame matches differ from TF32 off")
            require(ba_diff <= 1e-6, f"[tf32] {how}: BA rotations off TF32-off's by {ba_diff}")
    finally:
        tdist.destroy_process_group()


def graphs_phase(torch, dev, gpu: str, slam: dict, e2e: dict) -> dict:
    """[graphs]: the nine compiled entry points against their eager functions
    on the card (``tools/graphs.py``): three calls each on other inputs
    (PlaneSlam: [slam]'s 30 frames; the SLAM backends: its 30 keyframes,
    which must be bit-equal), the eager first call included, equal
    labels, matches and spawns, poses within [slam_card_vs_cpu]'s bounds;
    a held output unchanged; N calls launch each kernel N times; two
    cameras give two graphs; a recording made to fail (a host sync in a
    glue op, in a child process) raises and returns no labels. Times, eager
    and captured side by side; every graph's recording time and pool bytes.
    Returns the launches of the checks' compiled calls."""
    from deplex_tpu_torch.tools import graphs as graphs_tool

    with no_plain_glue():
        report = graphs_tool.run(dev, seq=slam["frames"], e2e=e2e)
    checks = report["checks"]
    launches = {}
    for name, row in checks.items():
        say("graphs", entry=name, **{k: v for k, v in row.items()
                                     if k not in ("capture_s", "pool_bytes")})
        for k, n in row.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + n
    for name, row in checks.items():
        if name == "forced_failure":
            require(row["pass"], f"[graphs] a failed recording did not raise: {row}")
            continue
        require(row["equal"], f"[graphs] {name}: captured results differ from eager: {row}")
        if name == "cameras":
            require(row["graphs"] == 1, f"[graphs] two cameras gave {row['graphs']} graphs")
            continue
        require(row.get("held", True), f"[graphs] {name}: a held output changed")
        require(row["launches_exact"], f"[graphs] {name}: launches {row['launches']} for "
                f"{row['calls']} calls")
        require(row["graphs"] == 1 and row["replays"] == row["calls"] - 1,
                f"[graphs] {name}: {row['graphs']} graphs, {row['replays']} replays")
    for name, row in report["timings"].items():
        say("graphs_time", metric=name, eager=f"{row['eager']:.3f}",
            captured=f"{row['captured']:.3f}", captured_over_eager=f"{row['captured'] / row['eager']:.3f}",
            gpu=repr(gpu))
    for g in report["graphs"]:
        say("graphs_pool", entry=g["entry"], inputs=g["inputs"], capture_s=f"{g['capture_s']:.4f}",
            pool_bytes=g["pool_bytes"], launches=g["launches"], replays=g["replays"],
            gpu=repr(gpu))
    for name in BACKENDS:
        require(checks[name]["bit_equal"], f"[graphs] {name}: captured not bit-equal to eager")
    for name in ("extract_depth_batch_jit", "ransac", "extract_planes_from_depth_jit",
                 "extract_planes_jit", "extract_planes_batch_jit", "extract_primitives_jit",
                 "PlaneSlam.frame_fn", *BACKENDS):
        row = checks[name]
        say("graphs_capture", entry=name, capture_s=[f"{x:.4f}" for x in row["capture_s"]],
            pool_bytes=row["pool_bytes"], gpu=repr(gpu))
    say("graphs_capture", b64_pool_bytes_tum=report["b64_pool_bytes"]["tum"],
        b64_pool_bytes_icl_p4=report["b64_pool_bytes"]["icl_p4"], gpu=repr(gpu))
    say("graphs_pool", pools_at_end_bytes=report["pool_bytes_total"],
        graphs_at_end=len(report["graphs"]), gpu=repr(gpu))
    require(report["pass"], "[graphs] the report did not pass")
    return launches


def native_phase(gpu: str, tum, K_tum, work: pathlib.Path) -> None:
    """[native]: the C++ decoder built on this host, bit-equal to the Python
    decoder on TUM, ICL and a 640x480 frame under each PNG filter type
    (4 = Paeth on every row); back-projection bit-equal; decode times."""
    from deplex_tpu_torch import native
    from deplex_tpu_torch.utils.depth_image import _python_load_png16, backproject, write_png16

    require(native.available(), "[native] the native library did not build")
    say("native", cxx=repr(native.build_info["cxx"]), libz=native.build_info["libz"],
        zlib_h=os.path.exists("/usr/include/zlib.h"), library=native.build_info["library"])
    files = {"tum": str(DATA / "tum" / "1341848230.910894.png"),
             "icl": str(DATA / "icl_nuim" / "0.png")}
    for f in range(5):
        files[f"tum_filter{f}"] = str(work / f"tum_filter{f}.png")
        write_png16(files[f"tum_filter{f}"], tum.data, filter_type=f)
    for name, path in files.items():
        got, ref = native.decode_png16(path), _python_load_png16(path)
        require(got is not None and np.array_equal(got, ref),
                f"[native] {name}: native decode differs from the Python decoder")
        if name.startswith("tum_filter"):
            require(np.array_equal(got, tum.data), f"[native] {name}: not the written frame")
    K = np.asarray(K_tum, np.float32)
    require(np.array_equal(native.backproject(tum.data, K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                           backproject(tum.data, K)),
            "[native] backproject differs from utils/depth_image.backproject")

    def ms(fn, path, reps):
        fn(path)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(path)
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))
    say("native_time", host=repr(os.uname().nodename), cpus=os.cpu_count(),
        tum_native_ms=f"{ms(native.decode_png16, files['tum'], 20):.3f}",
        tum_python_ms=f"{ms(_python_load_png16, files['tum'], 5):.3f}",
        paeth_native_ms=f"{ms(native.decode_png16, files['tum_filter4'], 20):.3f}",
        paeth_python_ms=f"{ms(_python_load_png16, files['tum_filter4'], 2):.3f}",
        gpu=repr(gpu))


def sequence_phase(torch, dev, gpu: str, tum, K_tum, slam: dict, work: pathlib.Path) -> dict:
    """[sequence]: tools/make_sequence writes [slam]'s 30 warped TUM frames as
    PNGs; examples.process_sequence streams them through the native
    SequenceLoader (every frame a native decode) to the same labels as the
    in-memory frames; frames/s including the decode, streaming and B=8.
    Returns the streaming run's kernel launches."""
    from deplex_tpu_torch import Config, PlaneExtractor, kernels, native
    from deplex_tpu_torch.examples.process_sequence import process_sequence, sequence_paths
    from deplex_tpu_torch.tools.make_sequence import write_sequence

    frames = len(slam["frames"])
    seq_dir = work / "tum_seq"
    t0 = time.perf_counter()
    write_sequence(seq_dir, str(DATA / "tum" / "1341848230.910894.png"),
                   str(DATA / "configs" / "TUM_fr3_long_val.K"), frames, seed=0)
    write_s = time.perf_counter() - t0
    paths = sequence_paths(seq_dir)
    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini"))
    kernels.reset_launch_counts()
    native.reset_decode_counts()
    with no_plain_glue():
        streamed = process_sequence(paths, K_tum, cfg, device=dev)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    decodes = native.decode_counts()
    say("sequence", frames=len(paths), decodes=decodes, launches=launches,
        write_s=f"{write_s:.1f}")
    require(decodes == {"native": frames, "python": 0}, f"[sequence] decodes {decodes}")
    require_launches(launches, "[sequence]", least=frames)
    ex = PlaneExtractor(tum.height, tum.width, cfg, device=dev)
    memory = [ex.process_depth(d, K_tum) for d in slam["frames"]]
    batched = process_sequence(paths, K_tum, cfg, batch=8, device=dev)
    differing = [int((a != b).sum()) for a, b in zip(streamed["labels"], memory)]
    differing_b8 = [int((a != b).sum()) for a, b in zip(batched["labels"], memory)]
    say("sequence", labels_vs_in_memory_pixels_differing=sum(differing),
        batch8_pixels_differing=sum(differing_b8))
    require(len(streamed["labels"]) == frames and not any(differing),
            f"[sequence] streamed labels differ from the in-memory frames': {differing}")
    require(len(batched["labels"]) == frames and not any(differing_b8),
            f"[sequence] B=8 labels differ from the in-memory frames': {differing_b8}")
    lat = np.asarray(streamed["latency_s"]) * 1e3
    say("sequence_time", streaming_fps=f"{frames / float(np.sum(streamed['latency_s'])):.1f}",
        streaming_ms_min=f"{lat.min():.3f}", streaming_ms_mean=f"{lat.mean():.3f}",
        streaming_ms_max=f"{lat.max():.3f}",
        batch8_fps=f"{frames / float(np.sum(batched['latency_s'])):.1f}", gpu=repr(gpu))
    return launches


def slam_seq_phase(torch, gpu: str, slam: dict, work: pathlib.Path) -> dict:
    """[slam_seq]: examples.run_slam --dataset on [sequence]'s PNGs with the
    golden's arguments: ATE beside the golden's, within [slam]'s bounds, and
    the same per-frame matches and tracked poses as [slam]'s in-memory run
    on the same uint16 frames. Returns the path's kernel launches."""
    from deplex_tpu_torch import kernels, native
    from deplex_tpu_torch.examples import run_slam

    golden = json.loads((DATA / "golden" / "slam_ate_tum30.json").read_text())
    frames = len(slam["frames"])
    args = run_slam.parse_args(
        ["--dataset", str(work / "tum_seq"), "--frames", str(frames),
         "--config", str(DATA / "configs" / "TUM_fr3_long_val.ini"),
         "--intrinsics", str(DATA / "configs" / "TUM_fr3_long_val.K"),
         "--max-landmarks", str(golden["args"]["max_landmarks"])])
    kernels.reset_launch_counts()
    native.reset_decode_counts()
    t0 = time.perf_counter()
    with no_plain_glue():
        report, tracked, counts = run_slam.run_dataset(args)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ate, ref = report["ate_rmse_mm"], golden["ate_rmse_mm"]
    say("slam_seq", frames=report["frames"], decodes=native.decode_counts(), launches=launches,
        ate_tracking_mm=ate["tracking"], ate_ba_mm=ate["ba"], ate_pose_graph_mm=ate["pose_graph"],
        landmarks=report["landmarks"],
        golden=f"{ref['tracking']}/{ref['ba']}/{ref['pose_graph']}mm,"
               f"{golden['landmarks']}landmarks")
    require_launches(launches, "[slam_seq]", least=frames, labels=0)
    require(native.decode_counts() == {"native": frames, "python": 0},
            f"[slam_seq] decodes {native.decode_counts()}")
    require(ate["tracking"] < 300.0, f"[slam_seq] tracking ATE {ate['tracking']} mm")
    require(ate["ba"] <= 1.05 * ate["tracking"] and ate["pose_graph"] <= 1.05 * ate["tracking"],
            f"[slam_seq] backend ATE above 1.05 x tracking: {ate}")
    dR = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(tracked, slam["tracked"]))
    dt = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(tracked, slam["tracked"]))
    say("slam_seq_vs_in_memory", frames_equal=sum(a == b for a, b in zip(counts, slam["counts"])),
        max_rotation_diff=f"{dR:.3e}", max_translation_diff_mm=f"{dt:.3e}")
    require(counts == slam["counts"], f"[slam_seq] per-frame matches differ from [slam]'s: "
                                      f"{counts} vs {slam['counts']}")
    require(dR == 0.0 and dt == 0.0, f"[slam_seq] tracked poses differ from [slam]'s by "
                                     f"{dR} (rotation) / {dt} mm")
    say("slam_seq_time", wall_s=f"{wall_s:.1f}", gpu=repr(gpu))
    return launches


def slam_seq_icl_phase(torch, gpu: str, work: pathlib.Path, cpu_frames: int = 10) -> dict:
    """[slam_seq_icl]: BASELINE.json config 3, the ICL-NUIM sequence at P=4
    with the golden's own arguments (data/golden/slam_ate_icl30.json):
    tools/make_sequence writes 30 warped frames (seed 0), examples.run_slam
    --dataset tracks them on the card. The plane kernels once a frame; ATE beside the
    golden's within [slam]'s bounds; the CPU twins over the first
    `cpu_frames` frames of the same PNGs: equal per-frame matches, poses
    within [slam_card_vs_cpu]'s bounds. Returns the path's launches."""
    from deplex_tpu_torch import Config, PlaneSlam, kernels, native
    from deplex_tpu_torch.examples import run_slam
    from deplex_tpu_torch.pipeline import backproject_device, depth_tensor
    from deplex_tpu_torch.tools.make_sequence import write_sequence
    from deplex_tpu_torch.utils import read_intrinsics

    golden = json.loads((DATA / "golden" / "slam_ate_icl30.json").read_text())
    frames = golden["args"]["frames"]
    ini, kfile = DATA / "configs" / "ICL_living_room.ini", DATA / "configs" / "ICL_living_room.K"
    seq = work / "icl_seq"
    t0 = time.perf_counter()
    paths = write_sequence(seq, str(DATA / "icl_nuim" / "0.png"), str(kfile), frames,
                           seed=golden["sequence_manifest"]["seed"])
    write_s = time.perf_counter() - t0
    args = run_slam.parse_args(
        ["--dataset", str(seq), "--frames", str(frames), "--config", str(ini),
         "--intrinsics", str(kfile), "--max-landmarks", str(golden["args"]["max_landmarks"]),
         "--report", str(work / "icl_report.json")])
    kernels.reset_launch_counts()
    native.reset_decode_counts()
    t0 = time.perf_counter()
    with no_plain_glue():
        report, tracked, counts = run_slam.run_dataset(args)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ate, ref = report["ate_rmse_mm"], golden["ate_rmse_mm"]
    say("slam_seq_icl", frames=report["frames"], decodes=native.decode_counts(),
        launches=launches, ate_tracking_mm=ate["tracking"], ate_ba_mm=ate["ba"],
        ate_pose_graph_mm=ate["pose_graph"], landmarks=report["landmarks"],
        golden=f"{ref['tracking']}/{ref['ba']}/{ref['pose_graph']}mm,"
               f"{golden['landmarks']}landmarks")
    require_launches(launches, "[slam_seq_icl]", least=frames, exact=True, labels=0)
    require(native.decode_counts() == {"native": frames, "python": 0},
            f"[slam_seq_icl] decodes {native.decode_counts()}")
    require(report["frames"] == frames and len(tracked) == frames, "[slam_seq_icl] frames")
    require(ate["tracking"] < 300.0, f"[slam_seq_icl] tracking ATE {ate['tracking']} mm")
    require(ate["ba"] <= 1.05 * ate["tracking"] and ate["pose_graph"] <= 1.05 * ate["tracking"],
            f"[slam_seq_icl] backend ATE above 1.05 x tracking: {ate}")

    # The CPU twins on the first frames of the same PNGs (P=4 on the CPU is
    # the slow part: its frame count is cut, never the card's).
    cfg = Config.from_ini(str(ini))
    K = torch.as_tensor(read_intrinsics(str(kfile)))
    cpu = PlaneSlam(480, 640, cfg, max_landmarks=golden["args"]["max_landmarks"],
                    odom_iterations=10, device="cpu")
    cpu_counts = []
    t0 = time.perf_counter()
    for path in paths[:cpu_frames]:
        res = cpu.process_frame(backproject_device(depth_tensor(native.decode_png16(path), "cpu"),
                                                   K))
        cpu_counts.append((int(res.num_matched), int(res.num_new)))
    cpu_s = time.perf_counter() - t0
    dR = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(tracked, cpu.trajectory))
    dt = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(tracked, cpu.trajectory))
    say("slam_seq_icl_card_vs_cpu", frames=cpu_frames,
        frames_equal=sum(a == b for a, b in zip(counts, cpu_counts)),
        max_rotation_diff=f"{dR:.3e}", max_translation_diff_mm=f"{dt:.3e}")
    require(counts[:cpu_frames] == cpu_counts,
            f"[slam_seq_icl] per-frame (matched, new) differ: {counts[:cpu_frames]} vs "
            f"{cpu_counts}")
    require(dR <= SLAM_ROTATION_TOL and dt <= SLAM_TRANSLATION_TOL_MM,
            f"[slam_seq_icl] card poses off the CPU's by {dR} (rotation) / {dt} mm")
    say("slam_seq_icl_time", wall_s=f"{wall_s:.1f}", write_s=f"{write_s:.1f}",
        cpu_frames_s=f"{cpu_s:.1f}", gpu=repr(gpu))
    return launches


def spatial_phase(torch, dev, gpu: str) -> dict:
    """[spatial]: tools/spatial_bench on the card, one frame's cell rows
    split over 1 and 2 gloo ranks (parallel.launcher), at 1280x720 P=8 (the
    planes-only room) and on TUM: every rank's labels equal one process's,
    every kernel launched on every rank; times a rank against one process.
    Returns the kernel launches summed over the ranks and cases."""
    from deplex_tpu_torch.tools import spatial_bench

    report = spatial_bench.run(dev, ranks=(1, 2), repeats=5, timeout=DIST_TIMEOUT_S)
    total = {k: 0 for k in KERNELS}
    for row in report["rows"]:
        if row["ranks"] == 0:
            continue
        say("spatial", case=row["case"], shape=row["shape"], patch=row["patch"],
            ranks=row["ranks"], backend=row["backend"], devices=row["devices"],
            launches=row["launches"], labels_equal_single=row["labels_equal_single"],
            gathered_bytes=row["gathered_bytes"])
        require(not row["jax_imported"], "[spatial] a rank imported jax")
        require(all(row["labels_equal_single"]),
                f"[spatial] {row['case']}: labels differ from one process's")
        require_launches(row["launches"], f"[spatial] {row['case']}")
        for k, per_rank in row["launches"].items():
            total[k] += sum(per_rank)
    single = {r["case"]: r["single_process_ms"] for r in report["rows"] if r["ranks"] == 0}
    for row in report["rows"]:
        if row["ranks"]:
            say("spatial_time", case=row["case"], ranks=row["ranks"], rank_ms=row["rank_ms"],
                single_process_ms=single[row["case"]],
                over_single_process=row["over_single_process"], gpu=repr(gpu))
    require(report["pass"], "[spatial] spatial_bench failed")
    return total


def bench_720p_phase(dev, gpu: str) -> dict:
    """[bench_720p]: BASELINE.json config 4 through tools/bench_720p; every
    timed call's labels within its bounds. Returns its timed launches."""
    from deplex_tpu_torch.tools import bench_720p

    with no_plain_glue():
        report = bench_720p.run(dev)
    say("bench_720p", frame=report["frame"], batch=report["batch"], ring=report["ring"],
        ring_bytes=report["ring_bytes"], timed_calls=report["timed_calls"],
        planes_min=report["planes_min"], planes_max=report["planes_max"],
        labelled_share_min=report["labelled_share_min"], launches=report["launches"])
    say("bench_720p_time", frames_per_s=report["frames_per_s"],
        us_per_frame=report["us_per_frame"], gpu=repr(gpu))
    require(report["pass"], f"[bench_720p] a timed frame left the bounds: {report['bounds']}")
    require_launches(report["launches"], "[bench_720p]", least=report["timed_calls"],
                     exact=True)
    return report["launches"]


def scaling_phase(dev, gpu: str) -> dict:
    """[scaling]: tools/scaling_report, ShardedPlaneExtractor at 1 and 2
    ranks (gloo on one card, NCCL with a card a rank): labels equal one
    process's. Returns the timed launches summed over the ranks."""
    from deplex_tpu_torch.tools import scaling_report

    report = scaling_report.run(dev, ranks=(1, 2), frames_per_device=8, repeats=10,
                                timeout=DIST_TIMEOUT_S)
    total = {k: 0 for k in KERNELS}
    for row in report["rows"]:
        say("scaling", ranks=row["ranks"], backend=row["backend"], devices=row["devices"],
            batch=row["batch"], frames_per_s=row["frames_per_s"],
            scaling_efficiency=row["scaling_efficiency"],
            labels_equal_single=row["labels_equal_single"],
            launches_per_rank=row["launches_per_rank"], gpu=repr(gpu))
        require(not row["jax_imported"], "[scaling] a rank imported jax")
        require_launches(row["launches_per_rank"], "[scaling]")
        for k, per_rank in row["launches_per_rank"].items():
            total[k] += sum(per_rank)
    require(report["pass"], "[scaling] labels differ from one process's")
    if "note" in report:
        say("scaling", note=repr(report["note"]))
    return total


# Run in the installed wheel's directory by [wheel]: argv = PNG, K file, out.
WHEEL_CHECK = """
import json, pathlib, shutil, sys
import numpy as np
import deplex_tpu_torch
from deplex_tpu_torch import Config, PlaneExtractor, kernels, native
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.utils import DepthImage, read_intrinsics
img = DepthImage(sys.argv[1])
labels = PlaneExtractor(img.height, img.width, Config()).process_depth(img.data,
                                                                       read_intrinsics(sys.argv[2]))
try:
    _build._nvcc()
    nvcc = "found"
except RuntimeError:
    nvcc = None
np.save(sys.argv[3], labels)
print(json.dumps({"package": deplex_tpu_torch.__file__, "in_checkout": _build.in_checkout(),
                  "kernels_library": str(_build.library_path()),
                  "native_library": str(native.library_path()), "nvcc": nvcc,
                  "nvcc_on_path": shutil.which("nvcc"), "native_needs": native.build_info["libz"],
                  "launches": kernels.launch_counts(), "decodes": native.decode_counts(),
                  "planes": int(labels.max())}))
"""


def wheel_phase(gpu: str, tum, K_tum, tum_labels, work: pathlib.Path) -> dict:
    """[wheel]: build the wheel, install it outside the checkout, and run
    PlaneExtractor.process_depth from there with no nvcc reachable.
    Returns the installed run's kernel launches."""
    import zipfile

    from deplex_tpu_torch.tools import build_wheel

    t0 = time.perf_counter()
    built = build_wheel.build(dist=work / "dist")
    build_s = time.perf_counter() - t0
    with zipfile.ZipFile(built["wheel"]) as whl:
        names = whl.namelist()
        metadata = whl.read(next(n for n in names if n.endswith(".dist-info/METADATA"))).decode()
    say("wheel", wheel=built["wheel"].name, wheel_bytes=built["wheel_bytes"], files=len(names),
        prebuilt=[n for n in names if "/_prebuilt/" in n], native_needs=built["needed"],
        build_s=f"{build_s:.1f}")
    require(all(n.startswith("deplex_tpu_torch") for n in names), "[wheel] a foreign entry")
    require("jax" not in metadata, "[wheel] METADATA requires jax")
    site = work / "site"
    pip = subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
                          "--target", str(site), str(built["wheel"])],
                         capture_output=True, text=True)
    if pip.returncode != 0 and "No module named pip" in pip.stderr:
        with zipfile.ZipFile(built["wheel"]) as whl:
            whl.extractall(site)
        installer = "extracted (this machine has no pip)"
    else:
        require(pip.returncode == 0, f"[wheel] pip install failed:\n{pip.stdout}{pip.stderr}")
        installer = "pip"
    path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    env = dict(os.environ, PYTHONPATH=str(site), PATH=os.pathsep.join(path),
               CUDA_HOME=str(work / "no_cuda_home"))
    run_dir = work / "elsewhere"
    run_dir.mkdir()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", WHEEL_CHECK,
                           str(DATA / "tum" / "1341848230.910894.png"),
                           str(DATA / "configs" / "TUM_fr3_long_val.K"),
                           str(work / "wheel_labels.npy")],
                          cwd=run_dir, env=env, capture_output=True, text=True, timeout=300)
    run_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"[wheel] the installed package failed:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    labels = np.load(work / "wheel_labels.npy")
    differing = int((labels != tum_labels).sum())
    say("wheel", installer=installer, package=out["package"], in_checkout=out["in_checkout"],
        kernels_library=out["kernels_library"], native_library=out["native_library"],
        nvcc=out["nvcc"], libz=out["native_needs"], launches=out["launches"],
        decodes=out["decodes"], planes=out["planes"], pixels_differing=differing,
        run_s=f"{run_s:.1f}", gpu=repr(gpu))
    require(pathlib.Path(out["package"]).resolve().is_relative_to(site.resolve())
            and not out["in_checkout"], f"[wheel] imported {out['package']}")
    prebuilt = (site / "deplex_tpu_torch" / "_prebuilt").resolve()
    require(pathlib.Path(out["kernels_library"]).resolve().parent == prebuilt
            and pathlib.Path(out["native_library"]).resolve().parent == prebuilt,
            "[wheel] the libraries did not come from the wheel's _prebuilt/")
    require(out["nvcc"] is None and out["nvcc_on_path"] is None, "[wheel] nvcc was reachable")
    require(out["native_needs"] == "libz.so.1", f"[wheel] libz named as {out['native_needs']}")
    require(out["planes"] == 34 and differing == 0,
            f"[wheel] {out['planes']} planes, {differing} pixels differ from the checkout's")
    require_launches(out["launches"], "[wheel]", least=1, exact=True)
    require(out["decodes"] == {"native": 1, "python": 0}, f"[wheel] decodes {out['decodes']}")
    return out["launches"]


def profiling_phase(torch, dev, gpu: str, tum, K_tum, work: pathlib.Path) -> dict:
    """[profiling]: stage_timings on TUM (five keys with the shipped RANSAC
    ini, four without), and a trace of one eager B=1 depth call
    (``extract_planes_from_depth``: process_depth replays a graph, which
    has no ranges) holding the annotate ranges. Returns the kernel launches of the stage_timings call
    with the TUM ini."""
    from deplex_tpu_torch import Config, kernels, profiling
    from deplex_tpu_torch.pipeline import depth_tensor, extract_planes_from_depth

    pts = tum.transform_to_pcd(K_tum)
    kernels.reset_launch_counts()
    with no_plain_glue():
        plain = profiling.stage_timings(pts, tum.height, tum.width,
                                        Config.from_ini(str(DATA / "configs" /
                                                            "TUM_fr3_long_val.ini")),
                                        repeats=10, device=dev)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    ransac = profiling.stage_timings(
        pts, tum.height, tum.width,
        Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini")), repeats=3,
        device=dev)
    say("profiling", launches=launches,
        stage_ms={k: round(1e3 * v, 4) for k, v in plain.items()},
        ransac_stage_ms={k: round(1e3 * v, 4) for k, v in ransac.items()}, gpu=repr(gpu))
    require(tuple(plain) == profiling.STAGES[:4], f"[profiling] keys {tuple(plain)}")
    require(tuple(ransac) == profiling.STAGES, f"[profiling] RANSAC keys {tuple(ransac)}")
    require_launches(launches, "[profiling]")
    # The stage ranges exist in the eager function only: a replay of a
    # recorded graph has none. Trace and time extract_planes_from_depth.
    def eager_b1():
        return extract_planes_from_depth(depth_tensor(tum.data, dev), K_tum,
                                         config=Config()).cpu().numpy()

    eager_b1()
    with profiling.trace(str(work / "trace")):
        with profiling.annotate("process_depth"):
            eager_b1()
    files = list((work / "trace").glob("trace_*.json"))
    require(len(files) == 1, f"[profiling] trace files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    found = [n for n in ("process_depth", *profiling.STAGES[:4]) if n in names]
    device_events = sum(1 for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                              "gpu_memset"))
    say("profiling", trace_bytes=files[0].stat().st_size, annotate_ranges_found=found,
        device_events=device_events)
    require(len(found) == 5, f"[profiling] annotate ranges missing from the trace: {found}")

    # What the stage ranges cost a user call with no profiler attached: the
    # B=1 latency with pipeline.py's annotate as shipped and as a no-op,
    # interleaved in rounds.
    from deplex_tpu_torch import pipeline

    shipped = pipeline.annotate
    lat = {"ranges": [], "no_ranges": []}
    for _ in range(4):
        for key, ann in (("ranges", shipped), ("no_ranges", lambda name: contextlib.nullcontext())):
            pipeline.annotate = ann
            try:
                for _ in range(15):
                    t0 = time.perf_counter()
                    eager_b1()
                    lat[key].append(1e3 * (time.perf_counter() - t0))
            finally:
                pipeline.annotate = shipped
    say("profiling_time", b1_p50_ms_ranges=f"{float(np.median(lat['ranges'])):.4f}",
        b1_p50_ms_no_ranges=f"{float(np.median(lat['no_ranges'])):.4f}",
        calls_each=len(lat["ranges"]), gpu=repr(gpu))
    return launches


def sampling_phase(torch, dev, gpu: str, lib, rcases: dict, errs: list) -> dict:
    """[sampling]: stage 6's sampling kernel held bit-equal to its twin on
    every output (the merged cell labels, hyp, counts, the order, bounds,
    every ChunkState tensor) on [ransac]'s B=8 ring under the default
    draws, a caller's (MAXP, K, 3) and (B, MAXP, K, 3) ranks and ranks far
    outside the planes' pixels (negative, past 2^32, at the int64 limits:
    the floor divisions), on its first frame (B=1), the ICL ini batch (P=4,
    19,200 cells), the 720p batch (P=8), the 720p stress scene at P=4
    (57,600 cells: past the shared copy of the order, and refused by PR
    16's kernel), the ICL frame at P=2 (76,800 cells) and grids with empty
    planes (all zero; 4 planes of 64; labels merged already); the B=8 ring
    and the 720p P=4 pair also at every cluster size. Then its own launch
    timed behind a spin kernel at B=8, B=1, ICL P=4 B=4 and 720p P=4 B=2
    beside its bound in bytes (``kernel_bench.sampling_cost``) with the
    launch plan (blocks a frame, blocks, waves), the twin, and one stable
    torch.sort of the merged cell labels (its library column, the sort
    only). `errs` gathers the largest absolute differences; returns the
    times."""
    from deplex_tpu_torch.kernels import sampling as k_sampling
    from deplex_tpu_torch.ops import ransac as o_ransac
    from deplex_tpu_torch.pipeline import depth_tensor, intrinsics_tensor
    from deplex_tpu_torch.tools import kernel_bench as bench
    from deplex_tpu_torch.tools._common import mean_ms
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    def inputs(rcase, frames=None):
        planes = rcase["planes"]
        B = planes.labels_map.shape[0] if frames is None else frames
        return (planes.points[:B].to(torch.float32).contiguous(),
                planes.labels_map[:B].contiguous(), planes.merge_labels[:B].contiguous(),
                rcase["kw"]["image_width"], rcase["kw"]["patch_size"])

    def check(name, cfg, args, draws=None, what="default", cluster=None):
        if cluster is None:
            got = k_sampling.sample(*args, cfg, draws=draws)
        else:                         # a forced cluster size (kernel_bench: sampling.launch)
            launch, got = bench.sampling_launcher(lib, *args, cfg, draws=draws, cluster=cluster)
            launch()
        ref = o_ransac.sample_stage_reference(*args, cfg, draws=draws)
        pairs = {f: (getattr(got, f), getattr(ref, f))
                 for f in ("cells", "hyp", "counts", "cell_order", "bounds")}
        pairs.update({f"state.{f}": (a, b)
                      for f, a, b in zip(o_ransac.ChunkState._fields, got.state, ref.state)})
        unequal = [f for f, (a, b) in pairs.items() if not torch.equal(a, b)]
        if (got.chunk, got.chunks) != (ref.chunk, ref.chunks):
            unequal.append("chunks")
        # Equal infinities (run_best, best_loss) differ by nothing.
        err = max(float((a.double() - b.double()).nan_to_num(0.0).abs().max())
                  for a, b in pairs.values() if a.numel())
        errs.append(err)
        lm = args[1]
        B, G = lm.shape[0], lm[0].numel()
        plan = k_sampling.plan_on(lib, dev, B, G, cfg.max_planes,
                                  cfg.max_planes * got.hyp.shape[2])
        say("sampling", case=name, draws=what, batch=B, grid=f"{lm.shape[1]}x{lm.shape[2]}",
            patch=args[4], maxp=cfg.max_planes, cluster=cluster or plan.cluster,
            fit_blocks=plan.fit_blocks, planes_with_cells=int((got.counts > 0).sum()),
            degenerate=int((got.hyp[..., 3] == 1e30).sum()), bit_equal=not unequal,
            max_abs_err=err)
        require(not unequal, f"ransac_sampling {name} ({what}, cluster {cluster}): the kernel "
                f"differs from its twin in {unequal}")
        C = cluster or plan.cluster
        require(lib.dplx_ransac_sample_shared_bytes(cfg.max_planes, C) ==
                k_sampling.shared_bytes(cfg.max_planes, C) and
                lib.dplx_ransac_sample_fit_slots() == k_sampling.FIT_SLOTS,
                f"ransac_sampling {name}: kernels/sampling.py's shared_bytes or FIT_SLOTS is "
                f"not the kernel's")
        return got

    rc8 = rcases["tum_b8_ratio_0.15"]
    cfg8 = rc8["cfg"]
    args8 = inputs(rc8)
    B8, MAXP, K = args8[1].shape[0], cfg8.max_planes, cfg8.ransac_max_iterations
    base = check("tum_b8", cfg8, args8)
    gen = torch.Generator().manual_seed(1)
    check("tum_b8", cfg8, args8, o_ransac.draw_ranks(base.counts[0], K, gen), "ranks_maxp_k_3")
    check("tum_b8", cfg8, args8, o_ransac.draw_ranks(base.counts, K, gen), "ranks_b_maxp_k_3")
    wild = torch.randint(-(2 ** 40), 2 ** 40, (B8, MAXP, K, 3), generator=gen)
    wild[:, :, :7] = torch.tensor([[-1, -99, 2 ** 32], [2 ** 63 - 1] * 3, [-(2 ** 63)] * 3,
                                   [5, 5, 5], [-7, -7, -6], [0, 0, 0],
                                   [2 ** 32 + 3, -(2 ** 32), 2 ** 31]])
    check("tum_b8", cfg8, args8, wild.to(dev), "ranks_outside_the_planes")
    check("tum_b1", cfg8, inputs(rc8, 1))
    for name in ("icl_ini_p4_b4", "stress720_p8_b2"):
        check(name, rcases[name]["cfg"], inputs(rcases[name]))
    grids = bench.stage6_grids(dev, rc8)
    hi_args, hi_cfg = grids["stress720_p4_b2"][:5], grids["stress720_p4_b2"][5]
    check("stress720_p4_b2", hi_cfg, hi_args)
    for C in k_sampling.CLUSTER_SIZES:
        check("tum_b8", cfg8, args8, what=f"cluster_{C}", cluster=C)
        check("stress720_p4_b2", hi_cfg, hi_args, what=f"cluster_{C}", cluster=C)
    vga = bench.sampling_inputs(
        depth_tensor(DepthImage(str(DATA / "icl_nuim" / "0.png")).data[None], dev),
        intrinsics_tensor(read_intrinsics(str(DATA / "configs" / "ICL_living_room.K")), dev),
        rcases["icl_ini_p4_b4"]["cfg"].replace(patch_size=2))
    check("icl_vga_p2_b1", vga[5], vga[:5])
    pts2, lm2, ml2, W8, P8 = inputs(rc8, 2)
    check("all_zero_b2", cfg8, (pts2, torch.zeros_like(lm2), ml2, W8, P8))
    few = torch.remainder(lm2, 5)                      # planes 5-64 hold no cell
    check("four_planes_of_64_b2", cfg8, (pts2, few, ml2, W8, P8))
    check("merged_already_b2", cfg8, (pts2, few, None, W8, P8))

    times = {}
    timed = {"b8": (args8, cfg8), "b1": (inputs(rc8, 1), cfg8),
             "icl_ini_p4_b4": (inputs(rcases["icl_ini_p4_b4"]), rcases["icl_ini_p4_b4"]["cfg"]),
             "stress720_p4_b2": (hi_args, hi_cfg)}
    for key, (args, cfg) in timed.items():
        launch, out = bench.sampling_launcher(lib, *args, cfg)
        ms = mean_ms(launch, reps=50, warmup=3, prime=True)
        torch.cuda.synchronize()
        nbytes = bench.sampling_cost(*args, cfg, out)
        bound_ms, bound_by = bench.bound(nbytes, 0)
        B, G = args[1].shape[0], args[1][0].numel()
        plan = k_sampling.plan_on(lib, dev, B, G, cfg.max_planes,
                                  cfg.max_planes * out.hyp.shape[2])
        times[key] = {
            "ms": ms, "wrapper_ms": mean_ms(lambda: k_sampling.sample(*args, cfg), reps=20,
                                            warmup=3),
            "plain_ms": mean_ms(lambda: o_ransac.sample_stage_reference(*args, cfg), reps=5,
                                warmup=1),
            "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes, "share_of_bound": bound_ms / ms,
            "library_ms": mean_ms(bench.stable_sort_call(out.cells), reps=50, warmup=3,
                                  prime=True),
            "cells": G, "cluster": plan.cluster, "blocks": plan.blocks, "waves": plan.waves,
            "fit_blocks": plan.fit_blocks, "fit_waves": plan.fit_waves}
        say("time", kernel="ransac_sampling", case=key, batch=B,
            **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in times[key].items()},
            gpu=repr(gpu))
    require(times["icl_ini_p4_b4"]["waves"] == times["icl_ini_p4_b4"]["fit_waves"] == 1,
            "ransac_sampling: ICL P=4 B=4 is not one wave")
    return {**times["b8"], "library_call": "torch.sort(stable=True) of the (B, G) merged cell "
            "labels (the sort only)", **{k: times[k] for k in timed if k != "b8"}}


T_START = time.perf_counter()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import deplex_tpu_torch
    pkg = pathlib.Path(deplex_tpu_torch.__file__).resolve()
    require(ROOT in pkg.parents, f"deplex_tpu_torch imported from {pkg}, not this checkout")

    from deplex_tpu_torch import Config, PlaneExtractor, kernels
    from deplex_tpu_torch.kernels import _build
    from deplex_tpu_torch.kernels import cellfinal as k_final
    from deplex_tpu_torch.kernels import cellstats as k_cells
    from deplex_tpu_torch.kernels import growing as k_grow
    from deplex_tpu_torch.kernels import labels as k_labels
    from deplex_tpu_torch.kernels import merge as k_merge
    from deplex_tpu_torch.kernels import rounds as k_rounds
    from deplex_tpu_torch.ops import cellstats as o_cells
    from deplex_tpu_torch.ops import growing as o_grow
    from deplex_tpu_torch.ops import merge as o_merge
    from deplex_tpu_torch.parallel.batch import BatchDepthExtractor, depth_batch_graph
    from deplex_tpu_torch.kernels import ransac as k_ransac
    from deplex_tpu_torch.ops import ransac as o_ransac
    from deplex_tpu_torch.pipeline import (depth_tensor, full_float32, intrinsics_tensor,
                                           plane_stages)
    from deplex_tpu_torch.tools import conformance, stage_bench
    from deplex_tpu_torch.tools import graphs as graphs_tool
    from deplex_tpu_torch.tools import kernel_bench as bench
    from deplex_tpu_torch.tools._common import label_f1, mean_ms
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics
    from deplex_tpu_torch.utils.scenes import hires_scene

    # --- 1. environment ----------------------------------------------------
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi0 = smi.splitlines()[0].strip()
    dev = torch.device("cuda", 0)
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=run([nvcc, "--version"]).splitlines()[-1].replace(" ", "_"),
        gpu=repr(smi0))

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say("build", seconds=f"{build_s:.1f}", library=_build.library_path().name)
    for ln in ptxas:
        print("  ptxas:", ln)

    # --- inputs ------------------------------------------------------------
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K_tum = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    icl = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    K_icl = read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))
    K_t = intrinsics_tensor(K_tum, dev)          # K1 reads the intrinsics on the card
    cfg_tum = Config()
    cfg_icl = Config.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    H, W = tum.height, tum.width
    rng = np.random.default_rng(0)

    def rolled(depth, n):
        """n distinct frames: small shifts of one depth map."""
        return np.stack([np.roll(depth, (int(rng.integers(0, 8)), int(rng.integers(0, 8))),
                                 (0, 1)) for _ in range(n)])

    def staircases(n, h=120, w=160):
        """Synthetic scenes of random boxes: many touching segments to merge."""
        frames = []
        for _ in range(n):
            z = np.full((h, w), 4000, np.uint16)
            for _ in range(6):
                r0, c0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
                z[r0:r0 + 40, c0:c0 + 40] = int(rng.uniform(2000, 6000))
            frames.append(z)
        return np.stack(frames)

    K_syn = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]], np.float32)
    quadrants = np.stack([tum.data[:240, :320], tum.data[240:, :320],
                          tum.data[:240, 320:], tum.data[240:, 320:]])
    cfg_mixed = Config(max_region_growing_rounds=128)
    hi_pts, hi_h, hi_w = hires_scene()
    cases = [  # name, K1's input on the card, K (None: points), config
        ("tum_b8", depth_tensor(rolled(tum.data, 8), dev), K_tum, cfg_tum),
        ("icl_b2", depth_tensor(rolled(icl.data, 2), dev), K_icl, cfg_icl),
        ("mixed_rounds_b4", depth_tensor(quadrants, dev), K_tum, cfg_mixed),
        ("staircases_b4", depth_tensor(staircases(4), dev), K_syn, cfg_tum),
        # The 720p primitives path: K1's points entry at P=8, K2 on 90x160
        # cells, K3 at M=32.
        ("stress720_points_p8_b1",
         torch.as_tensor(hi_pts, device=dev).reshape(1, hi_h, hi_w, 3).contiguous(), None,
         Config(**HIRES)),
    ]

    # --- 3. each kernel against its twin on the card ------------------------
    # The largest absolute difference from the twin, over every output compared.
    errs = {name: [] for name in KERNELS}

    def max_abs_diff(got, ref) -> float:
        return max(float((a - b).abs().max()) for a, b in zip(got, ref))

    def check_moments(name, src, K, cfg):
        """K1 against its twin; returns K1's 13 planes."""
        planes = k_cells.cell_moment_planes(src, K, cfg)
        got = o_cells.moments_from_planes(planes)
        ref = o_cells.cell_moments_reference(src, K, cfg)
        for f in ("nr_valid", "disc_h", "disc_v"):
            require(torch.equal(getattr(got, f), getattr(ref, f)), f"{name}: {f} differs")
        torch.testing.assert_close(got.coord_sum, ref.coord_sum, rtol=1e-5, atol=1e-2)
        tr = torch.diagonal(ref.scatter, dim1=-2, dim2=-1).sum(-1)
        serr = (got.scatter - ref.scatter).abs()
        require(bool((serr <= 1e-4 * tr[..., None, None] + 1e-2).all()),
                f"{name}: scatter off by {float(serr.max())}")
        err = max_abs_diff(got, ref)   # all 13 moment planes
        errs["cell_moments"].append(err)
        bit_equal = all(torch.equal(getattr(got, f), getattr(ref, f)) for f in got._fields)
        say("k1", case=name, max_abs_err=err,
            scatter_max_rel=float((serr / (tr[..., None, None] + 1)).max()),
            bit_equal=bit_equal)
        require(bit_equal, f"{name}: K1's moment planes are not bit-equal to the twin's")
        return planes

    def check_equal(kernel, name, pairs: dict, **fields):
        """A kernel's outputs against its twin's, bit for bit: {output: (got,
        ref)}; records the largest absolute difference."""
        unequal = [f for f, (a, b) in pairs.items() if not torch.equal(a, b)]
        err = max((float((a.double() - b.double()).abs().max())
                   for a, b in pairs.values() if a.numel()), default=0.0)
        errs[kernel].append(err)
        say(kernel, case=name, **fields, bit_equal=not unequal, max_abs_err=err)
        require(not unequal, f"{name}: {kernel} differs from its twin in {unequal}")

    def check_cells(name, src, K, cfg):
        """K1, then the cell-finalize kernel against its twin on K1's planes
        (every CellStats field, the bins, the packed edges); returns the
        kernel's CellGrid."""
        planes = check_moments(name, src, K, cfg)
        return check_cells_on(name, planes, o_cells.patch_size(src.shape[1], src.shape[2], cfg),
                              cfg)

    def check_cells_on(name, planes, P, cfg):
        got = k_final.cell_finalize(planes, P, cfg)
        ref = o_grow.finalize_cells(o_cells.moments_from_planes(planes), P, cfg)
        check_equal("cell_finalize", name, dict(zip(
            (*o_cells.CellStats._fields, "bins", "edges"),
            zip((*got.stats, got.bins, got.edges), (*ref.stats, ref.bins, ref.edges)))),
            planar_cells=int(got.stats.planar.sum()))
        return got

    def check_round_finalize(name, grown, stats, cfg):
        """The round-finalize kernel against its twin on K2's outputs (the
        sums, the cell labels, every slot table), on 1, 2, 4 and 8 blocks a
        frame and the wrapper's choice; returns (labels_map, PlaneSegments)."""
        ref_rounds, ref_labels, ref_segments = o_grow.finalize_grown(*grown, stats, cfg)
        for C in (1, 2, 4, 8, None):
            rounds, labels_map, segments = k_rounds.round_finalize(*grown, stats, cfg,
                                                                   cluster=C)
            check_equal("round_finalize", name, {
                "sums": (rounds.sums, ref_rounds.sums), "labels_map": (labels_map, ref_labels),
                **{f: (getattr(segments, f), getattr(ref_segments, f))
                   for f in segments._fields}},
                cluster=C or k_rounds.cluster_size(
                    grown[0].shape[0], grown[0][0].numel(),
                    k_rounds.max_clusters(_build.library(), grown[0][0].numel(),
                                          cfg.max_region_growing_rounds)),
                nr_rounds=grown[2].tolist()[:8], nr_planes=segments.nr_planes.tolist()[:8])
        return labels_map, segments

    def check_rounds(name, cells, cfg):
        check_rounds_on(name, *bench.rounds_inputs(cells, cfg), cfg)

    def check_rounds_on(name, bins, mse, packed, cfg):
        """K2 against its twin, and the counters it added against the
        twin's: its frames, their rounds, the frames the CPU's rule
        (``radix_staged``) says the staging sorts by radix, those whose
        rounds run one row a lane (``multiwarp``) and the radix sorts'
        passes (``radix_passes``)."""
        before = k_grow.counters_of(dev).clone()
        got = k_grow.grow_rounds_loop(bins, mse, packed, cfg)
        counted = (k_grow.counters_of(dev) - before).tolist()
        edges, planar = o_grow.unpack_edges(packed)
        ref = o_grow.grow_rounds_loop(bins, mse, edges, planar, cfg)
        for f, a, b in zip(("round_map", "seeds", "nr_rounds"), got, ref):
            require(torch.equal(a, b), f"{name}: {f} differs")
        nb2 = cfg.histogram_bins_per_coord ** 2
        radix = int(k_grow.radix_staged(bins, planar, nb2).sum())
        rows = bins.shape[0] if k_grow.multiwarp(*bins.shape[1:], nb2) else 0
        passes = int(k_grow.radix_passes(bins, planar, mse, nb2).sum())
        require(counted == [bins.shape[0], int(ref[2].sum()), radix, rows, passes],
                f"{name}: counters {counted}, the twin's rules {radix} radix frames, "
                f"{rows} one row a lane, {passes} radix passes")
        err = max_abs_diff(got, ref)
        errs["grow_rounds"].append(err)
        say("k2", case=name, nr_rounds=got[2].tolist(), radix_frames=radix,
            multiwarp_frames=rows, radix_passes=passes, max_abs_err=err)

    def check_merge(name, cells, cfg):
        check_merge_on(name, *check_round_finalize(name, k_grow.grow_rounds(cells, cfg),
                                                   cells.stats, cfg), cfg)

    def check_merge_on(name, labels_map, segments, cfg):
        ml_got, m_got = k_merge.merge_planes(labels_map, segments, cfg)
        ml_ref, m_ref = o_merge.merge_planes_from_labels(labels_map, segments, cfg)
        require(torch.equal(ml_got, ml_ref), f"{name}: merge_labels differ")
        torch.testing.assert_close(m_got.n, m_ref.n, rtol=1e-4, atol=0)
        torch.testing.assert_close(m_got.normal, m_ref.normal, rtol=0, atol=1e-4)
        torch.testing.assert_close(m_got.mean, m_ref.mean, rtol=1e-4, atol=1e-2)
        torch.testing.assert_close(m_got.d, m_ref.d, rtol=1e-4, atol=1e-2)
        tr = torch.diagonal(m_ref.scatter, dim1=-2, dim2=-1).sum(-1)
        require(bool(((m_got.scatter - m_ref.scatter).abs()
                      <= 1e-4 * tr[..., None, None] + 1e-2).all()), f"{name}: scatter differs")
        diffs = {f: max_abs_diff([getattr(m_got, f)], [getattr(m_ref, f)])
                 for f in ("n", "coord_sum", "scatter", "normal", "mean", "d")}
        diffs["merge_labels"] = max_abs_diff([ml_got], [ml_ref])
        err = max(diffs.values())
        errs["merge_planes"].append(err)
        say("k3", case=name, nr_planes=segments.nr_planes.tolist(),
            merged=int((ml_got != torch.arange(cfg.max_planes, device=dev)).sum()),
            max_abs_err=err, worst=max(diffs, key=diffs.get),
            normal_max_abs_err=diffs["normal"],
            scatter_max_abs=float(m_ref.scatter.abs().max()))

    for name, src, K, cfg in cases:
        cells = check_cells(name, src, None if K is None else intrinsics_tensor(K, dev), cfg)
        check_rounds(name, cells, cfg)
        check_merge(name, cells, cfg)
    pts = torch.as_tensor(tum.transform_to_pcd(K_tum), device=dev).reshape(1, H, W, 3)
    check_cells("tum_points_b1", pts.contiguous(), None, cfg_tum)
    # One recorded graph for every camera: K1 with intrinsics it reads from
    # the card, a second camera in the same buffer, bit-equal again.
    K_other = intrinsics_tensor(K_icl, dev)
    check_cells("tum_b2_other_camera", depth_tensor(rolled(tum.data, 2), dev), K_other, cfg_tum)

    # K1 on a patch too large for its band kernel (one thread a cell from
    # global memory).
    check_cells("tum_p160_b2", depth_tensor(rolled(tum.data, 2), dev), K_t,
                Config(patch_size=160))
    # Cell finalize on grids that no band plan divides: 7 x 13 cells, and
    # 300 x 250 (P=4 over a 1200 x 1000 tiling of the TUM frame, strips of
    # 125 columns).
    check_cells("tum_7x13_b2", depth_tensor(rolled(tum.data, 2)[:, :70, :130].copy(), dev),
                K_t, cfg_tum)
    check_cells("tum_300x250_p4_b1",
                depth_tensor(np.tile(tum.data, (3, 2))[None, :1200, :1000].copy(), dev), K_t,
                Config(patch_size=4))

    # K2 on adversarial inputs: seeded random directed graphs (grids up to
    # ICL's, one over 64 columns that is not a multiple of 64, one over
    # 65,535 cells that runs on the global workspace; MSE ties inside bins;
    # asymmetric edges) and a serpentine wall through K1. Round finalize on
    # K2's rounds of each graph with seeded cell statistics (its cell arrays
    # in shared memory up to 48x64 cells, in the global workspace above).
    for batch, gh, gw in ((4, 7, 13), (4, 48, 64), (4, 50, 100), (4, 120, 160), (2, 300, 250)):
        arrays = [torch.from_numpy(a).to(dev)
                  for a in bench.random_rounds_case(rng, batch, gh, gw)]
        check_rounds_on(f"random_{gh}x{gw}_b{batch}", *arrays, cfg_tum)
        check_round_finalize(f"random_{gh}x{gw}_b{batch}",
                             k_grow.grow_rounds_loop(*arrays, cfg_tum),
                             bench.random_cell_stats(rng, batch, gh, gw, dev), cfg_tum)
    # K2's seed on its edge paths (kernel_bench.adversarial_rounds_case):
    # +inf, NaN, -0.0 and +0.0 MSE, dead prefixes of a bin's sorted list
    # longer than 32, the twin's cell-0 fallback; in shared memory (48x64,
    # 120x160) and on the global workspace (300x250).
    rng_adv = np.random.default_rng(20)
    for batch, gh, gw in ((6, 48, 64), (3, 120, 160), (3, 300, 250)):
        check_rounds_on(f"adversarial_{gh}x{gw}_b{batch}",
                        *[torch.from_numpy(a).to(dev)
                          for a in bench.adversarial_rounds_case(rng_adv, batch, gh, gw)],
                        cfg_tum)
    # K2's three round engines at their edges: kernel_bench's random and
    # adversarial B=8 frames (NaN MSE included; 120x160 one row a lane,
    # 48x64 the register band), and both kinds at B=3. One row a lane (3
    # words a row): 20x150 (one warp), 33x160 (a warp of one row; a last
    # word of 32 columns), 65x130 (a last word of 2), 97x150, 100x192 (a
    # full last word), 120x160 (ICL's) and 155x129 (five warps). The
    # memory band on warp 0 (other widths, or past 512 rows): 65x65,
    # 100x40, 500x30, 33x200, 60x256, 40x300 (5 words) and 520x36. The
    # global workspace (past shared memory): 97x256.
    for name, arrays in bench.k2_graph_cases(dev).items():
        check_rounds_on(name, *arrays, cfg_tum)
    for name, arrays in bench.k2_graph_cases(
            dev, ((20, 150), (33, 160), (65, 130), (97, 150), (100, 192), (120, 160),
                  (155, 129), (65, 65), (100, 40), (500, 30), (33, 200), (60, 256),
                  (40, 300), (520, 36), (97, 256)),
            batch=3, seed=22).items():
        check_rounds_on(name, *arrays, cfg_tum)
    # K2's radix sort (bench.sort_stress_case: one bin holds most counted
    # cells): one bin with ties that the cell breaks, NaN/+-0/+-inf keys,
    # keys that differ in every byte and in one byte (so the passes of the
    # bytes that do not differ are skipped), equal keys (no key pass); at
    # 400 bins (one bin pass) on ICL's 120x160 with the rank's bitmaps, on
    # 48x64 (bins in two passes: their counters do not fit the planes'
    # space), on 111x192 (ballots alone: 144 bytes of shared memory left
    # after its arrays) and on 300x250 (the global workspace); and at 1
    # bin, 484 (the most squared bins one pass takes) and 529 (two passes).
    rng_sort = np.random.default_rng(24)
    for gh, gw, per, kinds in ((120, 160, 20, bench.SORT_KINDS), (48, 64, 20, bench.SORT_KINDS),
                               (111, 192, 20, bench.SORT_KINDS),
                               (300, 250, 20, bench.SORT_KINDS),
                               (120, 160, 1, bench.SORT_KINDS),
                               (120, 160, 22, ("all_bytes", "special")),
                               (120, 160, 23, ("all_bytes", "special")),
                               (300, 250, 23, ("all_bytes",))):
        cfg_sort = cfg_tum.replace(histogram_bins_per_coord=per)
        for kind in kinds:
            arrays = [torch.from_numpy(a).to(dev) for a in
                      bench.sort_stress_case(rng_sort, 3, gh, gw, per * per, kind)]
            check_rounds_on(f"sort_{kind}_{gh}x{gw}_nb{per * per}_b3", *arrays, cfg_sort)
    # Round finalize at any number of rounds: 2048 (its per-round tables in
    # the global workspace too) on K2's rounds of a random graph, and 0 (no
    # round: every label 0, every slot empty).
    arrays = [torch.from_numpy(a).to(dev) for a in bench.random_rounds_case(rng, 4, 48, 64)]
    cfg_many = cfg_tum.replace(max_region_growing_rounds=2048)
    check_round_finalize("random_48x64_b4_r2048", k_grow.grow_rounds_loop(*arrays, cfg_many),
                         bench.random_cell_stats(rng, 4, 48, 64, dev), cfg_many)
    check_round_finalize("no_rounds_b4", (
        torch.full((4, 48, 64), -1, dtype=torch.int32, device=dev),
        torch.zeros((4, 0), dtype=torch.int32, device=dev),
        torch.zeros((4,), dtype=torch.int32, device=dev)),
        bench.random_cell_stats(rng, 4, 48, 64, dev), cfg_tum.replace(max_region_growing_rounds=0))
    # K3 on seeded label maps and tables: every kind on three grids, at
    # M = 64 (the warp kernel of the shipped configs), 8 (a part of a
    # warp), 100 and 128 (the block kernel, multi-word masks).
    for (gh, gw) in ((7, 13), (48, 64), (120, 160)):
        for M in (64, 8, 100, 128):
            for kind in bench.MERGE_KINDS:
                lm_case, seg_case = bench.merge_case_tensors(
                    bench.random_merge_case(rng, 4, gh, gw, M, kind), dev)
                check_merge_on(f"{kind}_{gh}x{gw}_m{M}_b4", lm_case, seg_case,
                               cfg_tum.replace(max_planes=M))

    serp = depth_tensor(np.broadcast_to(bench.serpentine_depth(H, W, cfg_tum.patch_size),
                                        (64, H, W)), dev)
    serp_cells = check_cells("serpentine_b64", serp, K_t, cfg_tum)
    serp_in = bench.rounds_inputs(serp_cells, cfg_tum)
    check_rounds_on("serpentine_b64", *serp_in, cfg_tum)
    serp_ms = mean_ms(bench.rounds_launcher(_build.library(), *serp_in, cfg_tum)[0],
                            reps=20, prime=True)
    say("k2_serpentine", batch=64, planar_cells=int(serp_cells.stats.planar[0].sum()),
        ms=f"{serp_ms:.4f}", gpu=repr(smi0))

    # Times at the serving shape: TUM, B=64. A kernel's own time is that of
    # its launch on inputs and outputs allocated once (tools/kernel_bench),
    # queued behind a spin kernel; the wrapper's and the twin's are not.
    B, P_tum = 64, cfg_tum.patch_size
    ring = depth_tensor(np.broadcast_to(tum.data, (B, H, W)), dev)
    # Both finalize kernels are held to their twins on the inputs they are
    # timed on.
    planes64 = k_cells.cell_moment_planes(ring, K_t, cfg_tum)
    cells64 = check_cells_on("tum_b64", planes64, P_tum, cfg_tum)
    stats64 = cells64.stats
    bins64, mse64, packed64 = bench.rounds_inputs(cells64, cfg_tum)
    edges64, _ = o_grow.unpack_edges(packed64)
    grown64 = k_grow.grow_rounds(cells64, cfg_tum)
    lm64, seg64 = check_round_finalize("tum_b64", grown64, stats64, cfg_tum)
    # B=1: the ring's first frame (8 blocks a frame on the H100's 132 SMs).
    planes1 = planes64[:, :1].contiguous()
    check_cells_on("tum_b1", planes1, P_tum, cfg_tum)
    grown1, stats1 = bench.first_frames(*grown64, stats64, 1)
    check_round_finalize("tum_b1", grown1, stats1, cfg_tum)
    lib = _build.library()
    rings = [depth_tensor(rolled(tum.data, B), dev) for _ in range(2)]
    launch_k1 = [bench.moments_launcher(lib, r, K_t, cfg_tum)[0] for r in rings]
    timing = {
        "cell_moments": (bench.alternate(launch_k1),
                         lambda: k_cells.cell_moment_planes(ring, K_t, cfg_tum),
                         lambda: o_cells.cell_moments_reference(ring, K_t, cfg_tum)),
        "cell_finalize": (bench.cells_launcher(lib, planes64, P_tum, cfg_tum)[0],
                          lambda: k_final.cell_finalize(planes64, P_tum, cfg_tum),
                          lambda: o_grow.finalize_cells(o_cells.moments_from_planes(planes64),
                                                        P_tum, cfg_tum)),
        "grow_rounds": (bench.rounds_launcher(lib, bins64, mse64, packed64, cfg_tum)[0],
                        lambda: k_grow.grow_rounds_loop(bins64, mse64, packed64, cfg_tum),
                        lambda: o_grow.grow_rounds_loop(bins64, mse64, edges64,
                                                        stats64.planar, cfg_tum)),
        "round_finalize": (bench.round_launcher(lib, *grown64, stats64, cfg_tum)[0],
                           lambda: k_rounds.round_finalize(*grown64, stats64, cfg_tum),
                           lambda: o_grow.finalize_grown(*grown64, stats64, cfg_tum)),
        "merge_planes": (bench.merge_launcher(lib, lm64, seg64, cfg_tum)[0],
                         lambda: k_merge.merge_planes(lm64, seg64, cfg_tum),
                         lambda: o_merge.merge_planes_from_labels(lm64, seg64, cfg_tum)),
    }
    costs = {"cell_moments": bench.moments_cost(rings[0], cfg_tum),
             "cell_finalize": (bench.cells_cost(planes64), 0),
             "grow_rounds": (bench.rounds_cost(bins64, cfg_tum), 0),
             "round_finalize": (bench.round_cost(grown64[0], cfg_tum), 0),
             "merge_planes": (bench.merge_cost(lm64, seg64), 0)}
    # One PyTorch call pair computing the same function: the region sums as
    # the one-hot float32 torch.bmm pair that computed them before the
    # round-finalize kernel (TF32 off). The other kernels have none.
    library = {"round_finalize": lambda: bench.onehot_region_sums(
        grown64[0], grown64[1], stats64, cfg_tum.max_region_growing_rounds)}
    at_b1 = {
        "cell_finalize": (bench.cells_launcher(lib, planes1, P_tum, cfg_tum)[0],
                          lambda: o_grow.finalize_cells(o_cells.moments_from_planes(planes1),
                                                        P_tum, cfg_tum),
                          bench.cells_cost(planes1)),
        "round_finalize": (bench.round_launcher(lib, *grown1, stats1, cfg_tum)[0],
                           lambda: o_grow.finalize_grown(*grown1, stats1, cfg_tum),
                           bench.round_cost(grown1[0], cfg_tum))}
    times = {}
    for name, (kern, wrapped, plain) in timing.items():
        ms = mean_ms(kern, reps=50, warmup=3, prime=True)
        bound_ms, bound_by = bench.bound(*costs[name])
        library_ms = None
        if name in library:
            with full_float32(dev):
                library_ms = mean_ms(library[name], reps=20, warmup=3)
        times[name] = {"ms": ms, "wrapper_ms": mean_ms(wrapped, reps=20, warmup=3),
                       "plain_ms": mean_ms(plain, reps=3, warmup=1),
                       "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
                       "share_of_bound": bound_ms / ms, "library_ms": library_ms}
        if name == "cell_finalize":
            # Its bound without the coord_sum and scatter copies, beside it
            # (kernel_bench.cells_cost); the kernels line keeps the full one.
            lean_ms, _ = bench.bound(bench.cells_cost(planes64, copies=False), 0)
            times[name].update(bound_without_copies_ms=lean_ms,
                               share_without_copies=lean_ms / ms)
        if name in at_b1:
            # The two finalize kernels at B=1 too (the online camera's call).
            kern1, plain1, cost1 = at_b1[name]
            ms1 = mean_ms(kern1, reps=50, warmup=3, prime=True)
            bound1, _ = bench.bound(cost1, 0)
            times[name]["b1"] = {"ms": ms1, "plain_ms": mean_ms(plain1, reps=3, warmup=1),
                                 "bound_ms": bound1, "share_of_bound": bound1 / ms1}
            say("time", kernel=name, batch=1, **{k: f"{v:.4f}" for k, v in
                                                  times[name]["b1"].items()}, gpu=repr(smi0))
        say("time", kernel=name, batch=B, **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                                              for k, v in times[name].items()}, gpu=repr(smi0))

    # The stage-6 chunk step (a chunk scored and the early-exit update applied
    # in one launch) against its twin after every chunk: the chunk's counts,
    # the state and scored bit-equal each time. Cases: [ransac]'s B=8 ring
    # with the shipped RANSAC ini (1000 hypotheses, 8 chunks of 128) at its
    # ratio 0.15, where no frame stops, and at 0.018, where frames stop early;
    # an ICL ini batch (P=4) and a 720p batch (P=8) with the same RANSAC
    # settings, where a block's run of cells spans plane boundaries at other
    # cell sizes; and 50 hypotheses in all (one chunk of 50). Then its own
    # launch timed beside its bound.
    cfg_ransac = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini"))
    ransac_keys = {k: getattr(cfg_ransac, k) for k in (
        "ransac_refinement", "ransac_max_iterations", "ransac_inliers_ratio", "ransac_threshold")}
    tum_ring8 = depth_tensor(ransac_ring(tum), dev)
    hi_pair = torch.as_tensor(np.stack([hi_pts.reshape(hi_h, hi_w, 3),
                                        np.roll(hi_pts.reshape(hi_h, hi_w, 3), 5, 1)]),
                              device=dev).contiguous()
    k6_cases = [
        ("tum_b8_ratio_0.15", tum_ring8, K_t, cfg_ransac),
        ("tum_b8_ratio_0.018", tum_ring8, K_t, cfg_ransac.replace(ransac_inliers_ratio=0.018)),
        ("icl_ini_p4_b4", depth_tensor(rolled(icl.data, 4), dev), intrinsics_tensor(K_icl, dev),
         cfg_icl.replace(**ransac_keys)),
        ("stress720_p8_b2", hi_pair, None,
         Config(**HIRES).replace(cylinder_extraction=False, **ransac_keys)),
        # Fewer hypotheses than a chunk: one chunk of 50, two per lane, a
        # count row that is not a multiple of four ints (the finisher's
        # scalar staging).
        ("tum_b8_k50", tum_ring8, K_t, cfg_ransac.replace(ransac_max_iterations=50)),
    ]
    k6_rcases = {}
    for name, src, K, cfg in k6_cases:
        rcase = k6_rcases[name] = bench.ransac_case(src, K, cfg)
        step_args = bench.ransac_step_args(rcase)
        got_state, ref_state = bench.ransac_state(rcase), bench.ransac_state(rcase)
        got_losses = torch.full_like(got_state.counts, -1)
        ref_losses = torch.full_like(got_state.counts, -1)
        equal_after = []
        for s_chunk in range(rcase["chunks"]):
            k_ransac.chunk_step(*step_args, got_state, s=s_chunk, losses=got_losses,
                                **rcase["kw"])
            o_ransac.chunk_step_reference(*step_args, ref_state, s=s_chunk, losses=ref_losses,
                                          **rcase["kw"])
            equal_after.append(torch.equal(got_losses, ref_losses) and all(
                torch.equal(g, r) for g, r in zip(got_state, ref_state)))
            errs["ransac_scores"].append(max_abs_diff([got_losses, got_state.best_k],
                                                      [ref_losses, ref_state.best_k]))
        scored = got_state.scored.tolist()
        say("k6", case=name, chunks=rcase["chunks"], run_cells=k_ransac.run_cells(
            rcase["kw"]["patch_size"]), scored=scored, reached=int(got_state.reached.sum()),
            bit_equal_after_chunk=equal_after, max_abs_err=errs["ransac_scores"][-1])
        require(all(equal_after), f"ransac_scores {name}: the chunk step differs from its "
                f"twin after chunks {[s for s, e in enumerate(equal_after) if not e]}")
        if name == "tum_b8_ratio_0.018":
            require(min(scored) < rcase["chunks"], f"{name}: no frame stopped early")
        if name == "tum_b8_ratio_0.15":
            tcase = rcase
    B8 = tcase["cells"].shape[0]
    not_done = torch.zeros(B8, dtype=torch.bool, device=dev)
    step_args = bench.ransac_step_args(tcase)
    wrapper_state = bench.ransac_state(tcase, never_done=True)
    plain_state = bench.ransac_state(tcase, never_done=True)
    ms = mean_ms(bench.ransac_launcher(lib, tcase, 0, bench.ransac_state(
        tcase, never_done=True), with_losses=False)[0], reps=50, warmup=3, prime=True)
    bound_ms, bound_by = bench.bound(*bench.ransac_cost(tcase, not_done),
                                     bench.FP32_UNFUSED_INSTRUCTIONS_PER_S)
    times["ransac_scores"] = {
        "ms": ms, "wrapper_ms": mean_ms(lambda: k_ransac.chunk_step(
            *step_args, wrapper_state, s=0, **tcase["kw"]), reps=20, warmup=3),
        "plain_ms": mean_ms(lambda: o_ransac.chunk_step_reference(
            *step_args, plain_state, s=0, **tcase["kw"]), reps=3, warmup=1),
        "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
        "share_of_bound": bound_ms / ms, "library_ms": None}
    say("time", kernel="ransac_scores", batch=B8, chunk=tcase["chunk"],
        **{k: (f"{v:.4f}" if isinstance(v, float) else v)
           for k, v in times["ransac_scores"].items()}, gpu=repr(smi0))

    # Stage 6's sampling kernel on the [k6] cases' stages 1-4, and its times.
    times["ransac_sampling"] = sampling_phase(torch, dev, smi0, lib, k6_rcases,
                                              errs["ransac_sampling"])

    # The labels kernel (stage 5's pixel labels in the output dtype, with
    # stage 6's final pass) bit-equal to its twin: on the inputs it is timed
    # on (TUM B=64 in uint8 and int32, its first frame, [ransac]'s B=8
    # winners at ratios 0.15 and 0.018), an ICL batch (P=4), the 720p scene
    # (P=8), a 475x633 crop (remainder strips; rows and frames that are no
    # multiple of 16 pixels), seeded tables of 255 and 300 planes (uint8
    # keeps the low 8 bits) and all-zero cell labels.
    ml64 = k_merge.merge_planes(lm64, seg64, cfg_tum)[0]
    lm1, ml1 = lm64[:1].contiguous(), ml64[:1].contiguous()

    def gathered(refine):
        """Stage 6's (points, hyp, best_k, threshold) as the twin takes it:
        the winners gathered (the kernel reads them itself)."""
        return refine and (refine[0], k_labels.winners(refine[1], refine[2]), refine[3])

    def check_labels(name, lm, ml, h, w, p, dtype, refine=None):
        got = k_labels.pixel_labels(lm, ml, h, w, p, dtype, refine=refine)
        ref = o_merge.pixel_labels_reference(lm, ml, h, w, p, dtype, gathered(refine))
        check_equal("pixel_labels", name, {"labels": (got, ref)}, batch=lm.shape[0],
                    image=f"{w}x{h}", patch=p, maxp=ml.shape[1], dtype=str(dtype)[6:],
                    stage6=refine is not None, labelled=int((got > 0).sum()))

    u8, i32 = torch.uint8, torch.int32
    check_labels("tum_b64", lm64, ml64, H, W, P_tum, u8)
    check_labels("tum_b64", lm64, ml64, H, W, P_tum, i32)
    check_labels("tum_b1", lm1, ml1, H, W, P_tum, u8)
    with full_float32(dev):
        icl_planes = plane_stages(depth_tensor(rolled(icl.data, 2), dev),
                                  intrinsics_tensor(K_icl, dev), cfg_icl)
        hi_planes = plane_stages(torch.as_tensor(hi_pts, device=dev).reshape(
            1, hi_h, hi_w, 3).contiguous(), None, Config(**HIRES))
        crop_planes = plane_stages(depth_tensor(rolled(tum.data, 2)[:, :475, :633].copy(), dev),
                                   K_t, cfg_tum)
    for dtype in (u8, i32):
        check_labels("icl_ini_p4_b2", *icl_planes[:2], icl.height, icl.width,
                     cfg_icl.patch_size, dtype)
        check_labels("tum_crop_475x633_b2", *crop_planes[:2], 475, 633, P_tum, dtype)
    check_labels("stress720_p8_b1", *hi_planes[:2], hi_h, hi_w, HIRES["patch_size"], i32)
    for M, dtypes in ((255, (u8,)), (300, (i32, u8))):
        lm_r = torch.from_numpy(rng.integers(0, M + 1, (4, 48, 64)).astype(np.int32)).to(dev)
        ml_r = torch.from_numpy(rng.integers(0, M, (4, M)).astype(np.int32)).to(dev)
        for dtype in dtypes:
            check_labels(f"random_maxp{M}_b4", lm_r, ml_r, H, W, P_tum, dtype)
    check_labels("all_zero_b4", torch.zeros_like(lm64[:4]), ml64[:4], H, W, P_tum, u8)
    for name in ("tum_b8_ratio_0.15", "tum_b8_ratio_0.018"):
        rcase = k6_rcases[name]
        for dtype in (u8, i32):
            check_labels(name, *rcase["planes"][:2], rcase["H"], rcase["kw"]["image_width"],
                         rcase["kw"]["patch_size"], dtype, rcase["refine"])
    # Its own launch, timed beside its bound (bytes: kernel_bench.labels_cost),
    # the twin, and one PyTorch call that expands the LUT'd uint8 cell map
    # (interpolate, mode="nearest"); int32, B=1 and stage 6's pass at B=8 too.
    rc8 = k6_rcases["tum_b8_ratio_0.15"]
    labels_at = {
        "uint8": (lm64, ml64, H, W, P_tum, u8),
        "int32": (lm64, ml64, H, W, P_tum, i32),
        "b1": (lm1, ml1, H, W, P_tum, u8),
        "ransac_b8": (*rc8["planes"][:2], rc8["H"], rc8["kw"]["image_width"],
                      rc8["kw"]["patch_size"], u8, rc8["refine"])}
    labels_times = {}
    for key, args in labels_at.items():
        ms = mean_ms(bench.labels_launcher(lib, *args)[0], reps=50, warmup=3, prime=True)
        bound_ms, bound_by = bench.bound(bench.labels_cost(*args), 0)
        refine = args[6] if len(args) > 6 else None
        labels_times[key] = {
            "ms": ms, "wrapper_ms": mean_ms(lambda: k_labels.pixel_labels(
                *args[:6], refine=refine), reps=20, warmup=3),
            "plain_ms": mean_ms(lambda: o_merge.pixel_labels_reference(*args[:6],
                                                                       gathered(refine)),
                                reps=5, warmup=1),
            "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}
        say("time", kernel="pixel_labels", case=key, batch=args[0].shape[0],
            **{k: (f"{v:.4f}" if isinstance(v, float) else v)
               for k, v in labels_times[key].items()}, gpu=repr(smi0))
    times["pixel_labels"] = {
        **labels_times["uint8"], "library_ms": mean_ms(
            bench.nearest_labels_call(lm64, ml64, P_tum), reps=20, warmup=3),
        "library_call": "torch.nn.functional.interpolate(uint8 LUT'd cells, mode='nearest')",
        **{key: labels_times[key] for key in ("int32", "b1", "ransac_b8")}}
    say("time", kernel="pixel_labels", batch=B, library_ms=f"{times['pixel_labels']['library_ms']:.4f}",
        library_call=times["pixel_labels"]["library_call"], gpu=repr(smi0))

    # Where the main path's time goes, stage by stage, at B=64, over a ring
    # of two batches of rolled frames (tools/stage_bench).
    stage_report = stage_bench.run(dev, batch=B, ring=2, repeats=10)
    say("stages", batch=B, ring=2, unit="us_per_frame", **stage_report["us_per_frame"])
    say("stages", share_of_stage_sum=stage_report["share_of_stage_sum"],
        planes_min=stage_report["planes_min"], planes_max=stage_report["planes_max"],
        gpu=repr(smi0))

    # --- 4. the main path, end to end ---------------------------------------
    extractor = BatchDepthExtractor(H, W, cfg_tum, batch=B, device=dev)
    ring_host = np.broadcast_to(tum.data, (B, H, W))
    extractor.process(ring_host, K_tum)              # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with no_plain_glue():
        labels64 = extractor.process(ring_host, K_tum)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("main_path", batch=B, launches=launches)
    require_launches(launches, "main path", exact=True)
    gold_tum = np.load(DATA / "golden" / "tum_default_labels.npz")["labels"]
    require(labels64.shape == (B, H * W), f"labels shape {labels64.shape}")
    require(bool((labels64 == labels64[0]).all()), "frames of one ring disagree")
    tum_labels = labels64[0].astype(np.int32)
    planes_tum = int(tum_labels.max())
    f1_tum = label_f1(tum_labels, gold_tum)
    say("tum", planes=planes_tum, f1=f"{f1_tum:.4f}", reference_f1="0.983", reference_planes=34)
    require(planes_tum == 34, f"TUM: {planes_tum} planes, expected 34")
    require(f1_tum >= 0.95, f"TUM: F1 {f1_tum}")

    # Golden conformance of the shipped configs (tools/conformance): F1 and
    # planes on the card, and the card against the plain twins on the CPU:
    # the same labels, K1's moment planes bit-equal. ICL at P=4 is the sharp
    # case: lambda_min is float32 noise there, so one last bit of a cell
    # normal can reorder the growing rounds.
    kernels.reset_launch_counts()
    with no_plain_glue():
        conf = conformance.run(dev)
        torch.cuda.synchronize()
    conformance_launches = kernels.launch_counts()
    for name, entry in conf["configs"].items():
        say("conformance", config=name, **entry)
    say("conformance", launches=conformance_launches, passed=conf["pass"])
    for name, entry in conf["configs"].items():
        require(entry["pass"], f"[conformance] {name}: {entry}")
    # Per config: one extraction on the card (K1, cell finalize, K2, round
    # finalize, K3 and the labels kernel once each), and K1 and cell finalize
    # once more for their outputs against the twins'; the CPU runs launch none.
    n_conf = len(conf["configs"])
    expected = {"cell_moments": 2 * n_conf, "cell_finalize": 2 * n_conf,
                "grow_rounds": n_conf, "round_finalize": n_conf, "merge_planes": n_conf,
                "pixel_labels": n_conf, "ransac_sampling": 0, "ransac_scores": 0}
    require(conformance_launches == expected,
            f"[conformance] launches {conformance_launches}, expected {expected}")
    cpu_tum = conformance.extract(tum.data, K_tum, cfg_tum, "cpu")
    require(np.array_equal(tum_labels, cpu_tum), "[conformance] B=64 TUM labels differ from "
            f"the CPU twins' at {int((tum_labels != cpu_tum).sum())} pixels")
    say("conformance", b64_vs_cpu="equal")
    tum_card = PlaneExtractor(H, W, cfg_tum, device=dev)
    via_points = tum_card.process(tum.transform_to_pcd(K_tum))
    via_depth = tum_card.process_depth(tum.data, K_tum)
    require(np.array_equal(via_points, via_depth), "process(points) != process_depth")
    require(np.array_equal(via_depth, tum_labels), "B=1 labels differ from the B=64 batch's")
    ex8 = BatchDepthExtractor(H, W, cfg_tum, batch=8, device=dev)
    batches = [rolled(tum.data, 8) for _ in range(3)]
    before = depth_batch_graph(batches[0].shape, cfg_tum, dev)
    replays = before.replays if before is not None else 0
    streamed = list(ex8.process_stream(batches, K_tum, max_in_flight=2))
    # Every batch after the one that records replays the graph in place.
    graph = depth_batch_graph(batches[0].shape, cfg_tum, dev)
    stream_replays = graph.replays - replays if graph is not None else 0
    require(graph is not None and stream_replays == len(batches) - (before is None),
            f"process_stream replayed its graph {stream_replays} times for {len(batches)} "
            "batches")
    require(len(streamed) == 3 and all(np.array_equal(o, ex8.process(b, K_tum))
                                       for b, o in zip(batches, streamed)),
            "process_stream labels differ from process")
    say("agree", points_vs_depth="equal", b1_vs_b64="equal", stream_batches=len(streamed),
        stream_replays=stream_replays)

    # Throughput at B=64 (device-resident ring of two batches, labels on the
    # card) and the B=1 latency of a user call (host depth in, host labels
    # out), eager and captured (the entry points replay CUDA graphs).
    e2e = graphs_tool.tum_timings(dev, tum.data, K_tum)
    fps, p50 = e2e["tum_b64_frames_per_s"], e2e["b1_process_depth_p50_ms"]
    say("e2e", frames_per_s_eager=f"{fps['eager']:.1f}",
        frames_per_s_captured=f"{fps['captured']:.1f}", batch=B,
        b1_p50_ms_eager=f"{p50['eager']:.3f}", b1_p50_ms_captured=f"{p50['captured']:.3f}",
        gpu=repr(smi0))

    # --- 5-18. each path with its own counts ---------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = pathlib.Path(tmp)
        by_path = {"main": launches, "conformance": conformance_launches,
                   "ransac": ransac_phase(torch, dev, smi0, tum, K_tum),
                   "primitives": primitives_phase(torch, dev, smi0, tum, K_tum)}
        by_path["slam"], slam = slam_phase(torch, dev, smi0, tum, K_tum, work)
        by_path["dist"] = dist_phase(torch, dev, smi0, tum, K_tum, slam, work)
        tf32_phase(torch, dev, tum, K_tum, slam)
        by_path["graphs"] = graphs_phase(torch, dev, smi0, slam, e2e)
        native_phase(smi0, tum, K_tum, work)
        by_path["sequence"] = sequence_phase(torch, dev, smi0, tum, K_tum, slam, work)
        by_path["slam_seq"] = slam_seq_phase(torch, smi0, slam, work)
        by_path["slam_seq_icl"] = slam_seq_icl_phase(torch, smi0, work)
        by_path["spatial"] = spatial_phase(torch, dev, smi0)
        by_path["bench_720p"] = bench_720p_phase(dev, smi0)
        by_path["scaling"] = scaling_phase(dev, smi0)
        by_path["profiling"] = profiling_phase(torch, dev, smi0, tum, K_tum, work)
        by_path["wheel"] = wheel_phase(smi0, tum, K_tum, tum_labels, work)
    say("script", seconds=f"{time.perf_counter() - T_START:.1f}")

    kernel_rows = [{"name": name, "route": "cuda", "source": KERNELS[name][0],
                    "replaces": KERNELS[name][1],
                    "launches": by_path[LAUNCHES_FROM[name]][name],
                    "launches_from": LAUNCHES_FROM[name],
                    "launches_by_path": {p: n.get(name, 0) for p, n in by_path.items()},
                    "max_abs_err": max(errs[name]), **times[name]} for name in KERNELS]

    print(smi0)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
