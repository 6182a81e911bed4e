#!/usr/bin/env python3
"""The compiled entry points (``compiled``) against their eager functions on
the card, and what a graph saves.

    python3 -m deplex_tpu_torch.tools.graphs [--out FILE]

Run from the repository root on a machine with a CUDA card. For each of
the nine counterparts of the JAX package's compiled programs
(``extract_depth_batch_jit`` at TUM B=64, ``extract_planes_from_depth_jit``,
``extract_planes_jit``, ``extract_planes_batch_jit`` at B=8,
``extract_primitives_jit`` at 1280x720 P=8, ``PlaneSlam``'s ``frame_fn``
over a warped 30-frame TUM sequence, and the SLAM backends on that run's
30 keyframes: ``run_ba`` (10 iterations, motion priors; 30 and 20
keyframes, one bucket of 32), the batched pair measurement
``PlaneSlam._pair_measure_fn`` over 300-435 candidate pairs (one padded
bucket of 512) and ``optimize_pose_graph`` (15 iterations; 434 and 334
edges, one bucket of 512)), from an empty cache:

  equal     each call on other inputs (rolled frames; for the backends other
            values and shapes within a bucket and, for run_ba, another
            damping; a main-path entry's first call is the eager run that
            precedes its recording, a backend's is an eager run alone and
            its second call records) against the eager function (for the
            backends, their eager twins here: the same padding, op by op)
            on the same inputs: labels, cell counts, matches and spawns
            equal, floats within stated bounds (and whether bit-equal);
  held      the second call's output unchanged after the third call;
  launches  N calls launch each kernel N times (the backends launch none;
            the labels kernel twice a call of extract_primitives_jit and
            none on the SLAM step);
  graphs    one graph for the entry, replayed N - 1 times.

``ransac`` holds ``extract_depth_batch_jit`` with the shipped RANSAC ini at
B=8 (stages 1-6 in one graph: K1-K3, the sampling kernels' two launches
and the scoring kernel once a chunk, 8 chunks, a call) to the same rows. Then ``cameras`` (two
intrinsics give one graph, each call equal to the eager result of its
camera) and ``forced_failure`` (in a fresh child process: a host sync
injected into a glue op makes the recording, and so the first call, raise,
and no labels come back; after it the allocator still recycles memory used
across streams, and the next call records and replays). Timings, eager and
captured side by side: TUM B=64 and ICL (P=4) B=64 frames/s on resident
rings, the B=1 ``process_depth`` latency (host depth in, host labels out),
the 720p ``process_primitives`` latency, the ``process_frame`` latency, and
``PlaneSlam.refine(10)`` and ``optimize_trajectory()`` on the 30 keyframes
(eager: through the backends' eager twins); every graph's recording time and pool
bytes (``b64_pool_bytes``: the TUM and ICL B=64 graphs'), and the bytes the
cache's pools hold at the end. The last line is a
JSON object with all of it.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

from deplex_tpu_torch import compiled, kernels
from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.ransac import DEFAULT_CHUNK
from deplex_tpu_torch.tools._common import DATA, ROOT, card_info, rolled_ring, write_report

# Card-vs-eager bounds on PlaneSlam poses (chip_smoke.py's card-vs-CPU
# bounds: rotation entries, translations in mm).
ROTATION_TOL, TRANSLATION_TOL_MM = 1e-5, 0.05
# Floats of a replay against the eager run (cylinder parameters, plane
# tables): replays launch the same kernels, so these hold with room.
FLOAT_RTOL, FLOAT_ATOL = 1e-5, 1e-4
HIRES = dict(patch_size=8, max_planes=32, min_region_growing_cells_activated=3,
             min_region_growing_candidate_size=3, max_region_growing_rounds=64)


def _clone(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def compare(got, ref) -> dict:
    """Leaves of two output trees: integer and bool leaves must be equal,
    float leaves within FLOAT_RTOL / FLOAT_ATOL; reports both."""
    gl, rl = tree_flatten(got)[0], tree_flatten(ref)[0]
    exact, close, bits, worst = True, True, True, 0.0
    for a, b in zip(gl, rl):
        if not isinstance(a, torch.Tensor):
            continue
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            bits = bits and torch.equal(a, b)
            close = close and bool(torch.allclose(a, b, rtol=FLOAT_RTOL, atol=FLOAT_ATOL,
                                                  equal_nan=True))
            if a.numel():
                worst = max(worst, float((a - b).abs().nan_to_num(0.0).max()))
        else:
            exact = exact and torch.equal(a, b)
            bits = bits and torch.equal(a, b)
    return {"discrete_equal": exact, "floats_close": close, "bit_equal": bits,
            "max_float_diff": worst, "ok": exact and close and len(gl) == len(rl)}


def per_call_launches(planes: int = 1, scores: int = 0, labels: int | None = None) -> dict:
    """Launches of each kernel one call makes: K1-K3 `planes` times each,
    the stage-6 scoring kernel `scores` times (one a chunk) and with it the
    sampling kernels once (``kernels.sampling.LAUNCHES_PER_CALL`` launches:
    the sort and the fits), the labels kernel `labels` times (`planes` when
    None; twice on the primitives path, none on the SLAM step, which writes
    no pixel labels)."""
    per = {"ransac_scores": scores,
           "ransac_sampling": kernels.sampling.LAUNCHES_PER_CALL * int(scores > 0),
           "pixel_labels": planes if labels is None else labels}
    return {name: per.get(name, planes) for name in kernels.MODULES}


def check_entry(entry: str, jit, eager, inputs, per_call: dict | None = None) -> dict:
    """Three (or more) calls of `jit` on `inputs` from an empty cache, held
    against `eager`; see the module docstring. `per_call`: launches of each
    kernel a call makes (``per_call_launches()``: K1-K3 and the labels
    kernel once, no stage 6)."""
    per_call = per_call_launches() if per_call is None else per_call
    compiled.clear()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = []
    for i, x in enumerate(inputs):
        outs.append(jit(x))
        if i == 1:
            held = _clone(outs[1])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    rows = [compare(o, eager(x)) for o, x in zip(outs, inputs)]
    mine = [g for g in compiled.graphs() if g.key[0] == entry]
    return {"calls": len(inputs), "launches": launches,
            "launches_exact": launches == {k: n * len(inputs) for k, n in per_call.items()},
            "equal": all(r["ok"] for r in rows), "bit_equal": all(r["bit_equal"] for r in rows),
            "max_float_diff": max(r["max_float_diff"] for r in rows),
            "held": compare(outs[1], held)["bit_equal"],
            "graphs": len(mine), "replays": sum(g.replays for g in mine),
            "capture_s": [g.capture_s for g in mine], "pool_bytes": [g.pool_bytes for g in mine]}


def slam_run(dev, seq, K, captured: bool):
    """PlaneSlam over `seq` (chip_smoke.py [slam]'s arguments); the eager
    run's step is ``frame_step`` itself. Returns (per-frame (matches_lm,
    num_new), trajectory, per-frame ms, kernel launches, the PlaneSlam)."""
    from deplex_tpu_torch import PlaneSlam
    from deplex_tpu_torch.pipeline import backproject_device, depth_tensor

    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini"))
    slam = PlaneSlam(seq[0].shape[0], seq[0].shape[1], cfg, max_landmarks=128,
                     odom_iterations=10, device=dev)
    if not captured:
        slam._frame_fn = slam._frame_step
    Kt = torch.as_tensor(K)
    steps, ms = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for depth in seq:
        t0 = time.perf_counter()
        res = slam.process_frame(backproject_device(depth_tensor(depth, dev), Kt))
        steps.append((res.matches_lm.cpu().numpy(), int(res.num_new)))
        ms.append(1e3 * (time.perf_counter() - t0))
    return steps, list(slam.trajectory), ms, kernels.launch_counts(), slam


def check_slam(dev, seq, K):
    """The ``frame_fn`` row, and the captured run's PlaneSlam."""
    compiled.clear()
    eager_steps, eager_traj, eager_ms, *_ = slam_run(dev, seq, K, captured=False)
    steps, traj, ms, launches, slam = slam_run(dev, seq, K, captured=True)
    mine = [g for g in compiled.graphs() if g.key[0] == "PlaneSlam.frame_fn"]
    dR = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(traj, eager_traj))
    dt = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(traj, eager_traj))
    same = all(np.array_equal(a[0], b[0]) and a[1] == b[1] for a, b in zip(steps, eager_steps))
    return {"calls": len(seq), "launches": launches,
            "launches_exact": launches == {k: n * len(seq)
                                           for k, n in per_call_launches(labels=0).items()},
            "matches_and_spawns_equal": same, "max_rotation_diff": dR,
            "max_translation_diff_mm": dt,
            "equal": same and dR <= ROTATION_TOL and dt <= TRANSLATION_TOL_MM,
            "bit_equal": dR == 0.0 and dt == 0.0,
            "graphs": len(mine), "replays": sum(g.replays for g in mine),
            "capture_s": [g.capture_s for g in mine], "pool_bytes": [g.pool_bytes for g in mine],
            "process_frame_p50_ms": {"eager": float(np.median(eager_ms)),
                                     "captured": float(np.median(ms))}}, slam


def eager_run_ba(problem, iterations: int = 10, damping: float = 1e-4):
    """``run_ba`` op by op: its LM loop on the problem padded to its
    keyframe bucket, cut back to the K keyframes."""
    from deplex_tpu_torch.pipeline import full_float32
    from deplex_tpu_torch.slam import ba

    K = problem.R.shape[0]
    with full_float32(problem.R.device):
        out = ba._lm_loop(ba.pad_problem_keyframes(problem, compiled.bucket(K)), iterations,
                          ba._damping(problem, damping), None)
    return out._replace(R=out.R[:K], t=out.t[:K])


def eager_pose_graph(g, iterations: int = 20, damping: float = 1e-5):
    """``optimize_pose_graph`` op by op: its steps on the graph padded to
    its node and edge buckets, the poses cut back to the K nodes."""
    from deplex_tpu_torch.pipeline import full_float32
    from deplex_tpu_torch.slam import pose_graph

    K = g.R.shape[0]
    with full_float32(g.R.device):
        h = pose_graph.pad_pose_graph(g, compiled.bucket(K), compiled.bucket(g.edge_a.shape[0]))
        for _ in range(iterations):
            h = pose_graph.pose_graph_step(h, damping=damping)
    return g._replace(R=h.R[:K], t=h.t[:K])


def eager_pair_measure(obs, lm_normal, lm_d, match, has, R0, t0):
    """``PlaneSlam._pair_measure_fn`` op by op (the inputs come padded)."""
    from deplex_tpu_torch.pipeline import full_float32
    from deplex_tpu_torch.slam.frontend import PAIR_ITERATIONS
    from deplex_tpu_torch.slam.odometry import estimate_pose

    with full_float32(R0.device):
        return estimate_pose(obs, lm_normal, lm_d, match, has, R0, t0,
                             iterations=PAIR_ITERATIONS)


@contextlib.contextmanager
def eager_backends(slam):
    """`slam`'s refine and optimize_trajectory through the backends' eager
    twins, as the frame_fn row puts ``_frame_step`` in ``_frame_fn``'s
    place."""
    from deplex_tpu_torch.slam import ba, pose_graph

    def run_ba(problem, *, iterations=10, damping=1e-4):
        return eager_run_ba(problem, iterations, damping)

    def optimize_pose_graph(g, *, iterations=20, damping=1e-5):
        return eager_pose_graph(g, iterations, damping)

    with mock.patch.object(ba, "run_ba", run_ba), \
            mock.patch.object(pose_graph, "optimize_pose_graph", optimize_pose_graph), \
            mock.patch.object(slam, "_pair_measure_fn", eager_pair_measure):
        yield


def first_keyframes(problem, n: int):
    """The BA problem of its first n keyframes (the landmarks unchanged)."""
    cut = {"R": n, "t": n, "obs_normal": n, "obs_d": n, "obs_lm": n, "obs_w": n,
           "odo_R": n - 1, "odo_t": n - 1, "odo_w": n - 1, "cv_w": n - 2}
    return problem._replace(**{f: getattr(problem, f)[:k] for f, k in cut.items()
                               if getattr(problem, f) is not None})


def check_backends(slam, seed: int = 5) -> dict:
    """The rows of the three SLAM backends on `slam`'s keyframes: each
    called three times on other values within one bucket (BA on the 30
    keyframes, perturbed by seeded noise with another damping, and on the
    first 20; the pose graph, perturbed, and without 100 of its edges; 435,
    400 and 300 candidate pairs), against its eager twin."""
    from deplex_tpu_torch.slam.ba import run_ba
    from deplex_tpu_torch.slam.pose_graph import optimize_pose_graph

    gen = torch.Generator(device=slam.device).manual_seed(seed)

    def noisy(x, scale):
        return x + scale * torch.randn(x.shape, generator=gen, device=x.device)

    problem = slam.build_ba_problem()
    problems = [(problem, 1e-4), (problem._replace(eta=noisy(problem.eta, 2.0)), 3e-4),
                (first_keyframes(problem._replace(t=noisy(problem.t, 1.0)), 20), 1e-3)]

    def ba(x):
        return run_ba(x[0], iterations=10, damping=x[1])

    graph = slam.build_pose_graph()
    E = graph.edge_a.shape[0]
    kept = torch.cat([torch.arange(40), torch.arange(140, E)]).to(graph.edge_a.device)
    graphs_in = [graph, graph._replace(t=noisy(graph.t, 2.0)),
                 graph._replace(**{f: getattr(graph, f)[kept]
                                   for f in ("edge_a", "edge_b", "meas_R", "meas_t", "weight")})]

    def pose_graph(g):
        return optimize_pose_graph(g, iterations=15)

    K = len(slam._keyframes)
    pairs = [(a, b) for a in range(K) for b in range(a + 1, K)]
    pair_in = [slam._pair_inputs(pairs[:n]) for n in (len(pairs), 400, 300)]
    none = per_call_launches(planes=0)
    return {"run_ba": check_entry("run_ba", ba, lambda x: eager_run_ba(x[0], 10, x[1]),
                                  problems, per_call=none),
            "PlaneSlam.pair_measure_fn": check_entry(
                "PlaneSlam.pair_measure_fn", lambda x: slam._pair_measure_fn(*x),
                lambda x: eager_pair_measure(*x), pair_in, per_call=none),
            "optimize_pose_graph": check_entry("optimize_pose_graph", pose_graph,
                                               lambda g: eager_pose_graph(g, 15), graphs_in,
                                               per_call=none)}


def backend_timings(slam, n: int = 2) -> dict:
    """refine(10) and optimize_trajectory() on `slam`'s keyframes (each call
    from the tracked state), eager and captured; the captured calls' graphs
    are recorded first (a backend's first call runs eagerly, its second
    records); the state is put back."""
    tracked, tracked_map = list(slam.trajectory), slam.map

    def refine():
        slam.trajectory, slam.map = list(tracked), tracked_map
        slam.refine(iterations=10)

    def optimize():
        slam.trajectory = list(tracked)
        slam.optimize_trajectory()

    def eager(fn):
        def run():
            with eager_backends(slam):
                fn()
        return run

    try:
        for fn in (refine, refine, optimize, optimize):
            fn()
        return {name: side_by_side(lambda call: _p50_ms(call, n), eager(fn), fn)
                for name, fn in (("refine10_ms", refine), ("optimize_trajectory_ms", optimize))}
    finally:
        slam.trajectory, slam.map = tracked, tracked_map
        slam._set_pose_from_trajectory()


def _fps(call, frames: int, iters: int) -> float:
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    torch.cuda.synchronize()
    return iters * frames / (time.perf_counter() - t0)


def _p50_ms(call, n: int) -> float:
    call()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        lat.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(lat))


def side_by_side(measure, eager, captured) -> dict:
    """measure(call) for eager and captured in turns (e, c, c, e); the mean
    of each side's two rounds."""
    out = {"eager": [], "captured": []}
    for r in range(2):
        for side in (("eager", "captured") if r % 2 == 0 else ("captured", "eager")):
            out[side].append(measure(eager if side == "eager" else captured))
    return {k: float(np.mean(v)) for k, v in out.items()}


def tum_timings(dev, tum, K) -> dict:
    """[e2e]'s numbers: TUM B=64 frames/s over a resident ring of two
    batches, and the B=1 process_depth latency, eager and captured."""
    from deplex_tpu_torch import PlaneExtractor
    from deplex_tpu_torch.parallel.batch import extract_depth_batch, extract_depth_batch_jit
    from deplex_tpu_torch.pipeline import depth_tensor, extract_planes_from_depth

    cfg, batch = Config(), 64
    rings = [depth_tensor(rolled_ring(tum, batch, seed=s), dev) for s in (0, 1)]
    turn = itertools.count()
    fps = side_by_side(
        lambda call: _fps(call, batch, 10),
        lambda: extract_depth_batch(rings[next(turn) % 2], K, cfg),
        lambda: extract_depth_batch_jit(rings[next(turn) % 2], K, config=cfg))
    ex = PlaneExtractor(tum.shape[0], tum.shape[1], cfg, device=dev)
    p50 = side_by_side(
        lambda call: _p50_ms(call, 15),
        lambda: extract_planes_from_depth(depth_tensor(tum, dev), K, config=cfg).cpu().numpy(),
        lambda: ex.process_depth(tum, K))
    return {"tum_b64_frames_per_s": fps, "b1_process_depth_p50_ms": p50}


def run(device=None, seq=None, e2e: dict | None = None) -> dict:
    """Every check and timing of the module docstring. `seq`: PlaneSlam's
    uint16 frames (default: 30 warped TUM frames); `e2e`: ``tum_timings``'
    result when the caller has it already."""
    from deplex_tpu_torch import PlaneExtractor
    from deplex_tpu_torch.parallel.batch import (depth_batch_graph, extract_depth_batch,
                                                 extract_depth_batch_jit, extract_planes_batch,
                                                 extract_planes_batch_jit)
    from deplex_tpu_torch.pipeline import (depth_tensor, extract_planes, extract_planes_from_depth,
                                           extract_planes_from_depth_jit, extract_planes_jit,
                                           extract_primitives, extract_primitives_jit,
                                           resolve_device)
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics
    from deplex_tpu_torch.utils.depth_image import backproject
    from deplex_tpu_torch.utils.scenes import hires_scene
    from deplex_tpu_torch.utils.warp import render_sequence, smooth_trajectory

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit("graphs: the CUDA graphs need a card")
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png")).data
    K = np.asarray(read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K")), np.float32)
    icl = DepthImage(str(DATA / "icl_nuim" / "0.png")).data
    K_icl = np.asarray(read_intrinsics(str(DATA / "configs" / "ICL_living_room.K")), np.float32)
    cfg_icl = Config.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    cfg = Config()
    H, W = tum.shape
    report = {**card_info(dev), "checks": {}}

    def frames(n, batch=None, seed=2):
        ring = rolled_ring(tum, n * (batch or 1), seed=seed)
        return ring if batch is None else ring.reshape(n, batch, H, W)

    def clouds(depths):
        return torch.as_tensor(np.stack([backproject(d, K) for d in depths.reshape(-1, H, W)])
                               .reshape(*depths.shape[:-2], H * W, 3), device=dev)

    checks = report["checks"]
    d64 = [depth_tensor(b, dev) for b in frames(3, 64)]
    checks["extract_depth_batch_jit"] = check_entry(
        "extract_depth_batch_jit", lambda d: extract_depth_batch_jit(d, K, config=cfg),
        lambda d: extract_depth_batch(d, K, cfg).to(torch.uint8), d64)
    # Stage 6 recorded with stages 1-5: the shipped RANSAC ini at B=8, its
    # loop of 8 chunks (1000 hypotheses, 128 a chunk) in the graph.
    cfg_ransac = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini"))
    chunks = -(-cfg_ransac.ransac_max_iterations // DEFAULT_CHUNK)
    checks["ransac"] = check_entry(
        "extract_depth_batch_jit", lambda d: extract_depth_batch_jit(d, K, config=cfg_ransac),
        lambda d: extract_depth_batch(d, K, cfg_ransac).to(torch.uint8),
        [depth_tensor(b, dev) for b in frames(3, 8, seed=4)],
        per_call=per_call_launches(scores=chunks))
    d1 = [depth_tensor(f, dev) for f in frames(3)]
    checks["extract_planes_from_depth_jit"] = check_entry(
        "extract_planes_from_depth_jit",
        lambda d: extract_planes_from_depth_jit(d, K, config=cfg),
        lambda d: extract_planes_from_depth(d, K, config=cfg), d1)
    size = dict(image_height=H, image_width=W, config=cfg)
    p1 = list(clouds(frames(3)))
    checks["extract_planes_jit"] = check_entry(
        "extract_planes_jit", lambda p: extract_planes_jit(p, **size),
        lambda p: extract_planes(p, **size), p1)
    p8 = list(clouds(frames(3, 8)))
    checks["extract_planes_batch_jit"] = check_entry(
        "extract_planes_batch_jit", lambda p: extract_planes_batch_jit(p, **size),
        lambda p: extract_planes_batch(p, **size), p8)
    hi_pts, hi_h, hi_w = hires_scene()
    hi_cfg = Config(**HIRES, cylinder_extraction=True)
    hi_grid = hi_pts.reshape(hi_h, hi_w, 3)
    hi = [torch.as_tensor(np.roll(hi_grid, (r, c), (0, 1)).reshape(-1, 3), device=dev)
          for r, c in ((0, 0), (3, 5), (7, 2))]
    hi_size = dict(image_height=hi_h, image_width=hi_w, config=hi_cfg)
    checks["extract_primitives_jit"] = check_entry(
        "extract_primitives_jit", lambda p: extract_primitives_jit(p, **hi_size),
        lambda p: extract_primitives(p, **hi_size), hi, per_call=per_call_launches(labels=2))
    if seq is None:
        seq = [np.clip(np.round(d), 0, 65535).astype(np.uint16)
               for d in render_sequence(tum, K, smooth_trajectory(30, seed=0))]
    checks["PlaneSlam.frame_fn"], slam = check_slam(dev, seq, K)
    checks.update(check_backends(slam))

    # Two cameras: one graph of the entry (the intrinsics are an input),
    # each call equal to the eager result of its own camera.
    compiled.clear()
    K2 = K.copy()
    K2[0, 0] *= 1.01
    K2[0, 2] += 3.0
    d = depth_tensor(tum, dev)
    cams = {}
    for name, k in (("tum", K), ("other", K2), ("tum_again", K), ("other_again", K2)):
        got = extract_planes_from_depth_jit(d, k, config=cfg)
        cams[name] = torch.equal(got, extract_planes_from_depth(d, k, config=cfg))
    mine = [g for g in compiled.graphs() if g.key[0] == "extract_planes_from_depth_jit"]
    checks["cameras"] = {"equal": all(cams.values()), "graphs": len(mine),
                         "replays": [g.replays for g in mine], "by_call": cams}

    checks["forced_failure"] = run_forced_failure()
    for name, row in checks.items():
        print(f"[graphs] {name}", json.dumps(row), flush=True)

    # Timings, eager and captured side by side; every graph's recording.
    compiled.clear()
    timings = dict(e2e) if e2e is not None else tum_timings(dev, tum, K)
    icl_rings = [depth_tensor(rolled_ring(icl, 64, seed=s), dev) for s in (0, 1)]
    turn = itertools.count()
    timings["icl_p4_b64_frames_per_s"] = side_by_side(
        lambda call: _fps(call, 64, 5),
        lambda: extract_depth_batch(icl_rings[next(turn) % 2], K_icl, cfg_icl),
        lambda: extract_depth_batch_jit(icl_rings[next(turn) % 2], K_icl, config=cfg_icl))
    # The B=64 graphs' pools: TUM's from its check above, ICL's (P=4) just
    # recorded.
    report["b64_pool_bytes"] = {
        "tum": checks["extract_depth_batch_jit"]["pool_bytes"][0],
        "icl_p4": depth_batch_graph((64, *icl.shape), cfg_icl, dev).pool_bytes}
    hi_ex = PlaneExtractor(hi_h, hi_w, Config(**HIRES), device=dev)
    timings["primitives_720p_p50_ms"] = side_by_side(
        lambda call: _p50_ms(call, 10),
        lambda: tree_map(lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else x,
                         extract_primitives(hi[0], **hi_size)),
        lambda: hi_ex.process_primitives(hi_pts))
    timings["process_frame_p50_ms"] = checks["PlaneSlam.frame_fn"]["process_frame_p50_ms"]
    timings.update(backend_timings(slam))
    report["timings"] = timings
    report["graphs"] = [{"entry": g.key[0], "inputs": [s[0] for s in g.key[2]],
                         "capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                         "launches": g.launches, "replays": g.replays}
                        for g in compiled.graphs()]
    report["pool_bytes_total"] = compiled.pool_bytes(dev)
    report["pass"] = all(c["equal"] and c.get("held", True) and c.get("launches_exact", True)
                         and c.get("graphs", 1) == 1
                         for n, c in checks.items() if n != "forced_failure") \
        and checks["forced_failure"]["pass"]
    return report


def run_forced_failure(timeout: float = 300.0) -> dict:
    """``forced_failure`` in a fresh child process, so that its memory
    measure starts from an allocator no other graph has used. It passes if
    the call raised with no labels and nothing cached, the allocator still
    recycles memory used across streams, and the next call recorded and
    replayed."""
    proc = subprocess.run([sys.executable, "-m", "deplex_tpu_torch.tools.graphs",
                           "--forced-failure-child"], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1]) if lines else {"stderr": proc.stderr[-2000:]}
    out["returncode"] = proc.returncode
    out["pass"] = bool(proc.returncode == 0 and out.get("raised") and not out.get("labels")
                       and out.get("graphs_after_failure") == 0
                       and out.get("cross_stream_reuse") and out.get("recovered"))
    return out


CHURN_ROUNDS, CHURN_BYTES = 40, 128 << 20


def cross_stream_churn_mb(dev) -> float:
    """MB that reserved memory grows by over CHURN_ROUNDS allocations of
    CHURN_BYTES, each used on a side stream (``record_stream``) and freed.
    The allocator recycles such a block once its event has passed, unless
    a pool routing is still on: then it skips that step and every round
    takes new memory (CHURN_ROUNDS * CHURN_BYTES in all)."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    side = torch.cuda.Stream(dev)
    before = torch.cuda.memory_reserved(dev)
    for _ in range(CHURN_ROUNDS):
        x = torch.empty(CHURN_BYTES // 4, device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            x.add_(1)
        x.record_stream(side)
        del x
    torch.cuda.synchronize(dev)
    return (torch.cuda.memory_reserved(dev) - before) / 2**20


def forced_failure_child() -> dict:
    """A host sync injected into stage 5 (``pipeline.write_labels``: it
    reads a count on the host): the eager first call runs it, its recording
    cannot, so
    ``process_depth`` must raise and return no labels; nothing is cached.
    Then memory used across streams must still be recycled (the failed
    recording's pool routing was ended: the churn grows by less than half
    of what it allocates), and, without the sync, the same call records and
    replays."""
    from deplex_tpu_torch import PlaneExtractor, pipeline
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png")).data
    K = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    ex = PlaneExtractor(tum.shape[0], tum.shape[1], Config(), device="cuda")
    dev = ex.device
    real = pipeline.write_labels

    def syncing(planes, *args, **kwargs):
        int(planes.labels_map.sum())     # a host read: waits for the device
        return real(planes, *args, **kwargs)

    pipeline.write_labels = syncing
    out = {"raised": False, "labels": None}
    try:
        out["labels"] = int(ex.process_depth(tum, K).max())
    except RuntimeError as e:
        out.update(raised=True, error=str(e).strip().splitlines()[0][:300])
    finally:
        pipeline.write_labels = real
    out["graphs_after_failure"] = len(compiled.graphs())
    churn = cross_stream_churn_mb(dev)
    out["churn_mb_after_failure"] = churn
    out["cross_stream_reuse"] = churn < 0.5 * CHURN_ROUNDS * CHURN_BYTES / 2**20
    try:
        first, second = ex.process_depth(tum, K), ex.process_depth(tum, K)
        out["recovered"] = bool(np.array_equal(first, second)) and len(compiled.graphs()) == 1
    except RuntimeError as e:
        out["recovered"] = False
        out["recover_error"] = str(e).strip().splitlines()[0][:300]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the report here (JSON)")
    ap.add_argument("--forced-failure-child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("graphs: no CUDA device", file=sys.stderr)
        return 2
    if args.forced_failure_child:
        print(json.dumps(forced_failure_child()))
        return 0
    report = run()
    print(json.dumps(report))
    if args.out:
        write_report(args.out, report)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
