#!/usr/bin/env python3
"""Where the device time goes on each path, and what the float64 route costs.

    python3 -m deplex_tpu_torch.tools.profile_path [--only ROW,...]

Run from the repository root on a machine with a CUDA card. It drives
``extract_depth_batch`` on the TUM frame and prints one line per phase:

  transcendentals  share of 1e5 float32 inputs on which the card and the CPU
                   give other bits, for torch's float32 functions and for
                   the same functions through ``ops.eigh3x3.f64_rounded``;
  card_vs_cpu      pixels whose labels differ between the card and the CPU
                   twins, on TUM (P=10) and ICL (P=4), with the plain stages
                   in each mode (``f64``: as shipped; ``f32``: torch's
                   float32 functions in place of ``f64_rounded``; stages
                   1-3 are kernels on the card, always in double, so the
                   mode moves the CPU twins and the card's cylinders only);
  profile          torch.profiler over calls after warm-up, per mode and
                   batch: runtime launches (kernel, copy, set and graph
                   launch calls) and device operations per call, device
                   busy ms per call and its share of the profiled wall
                   time, the unprofiled wall ms per call, and the
                   ``TOP_OPS`` kernels with the most device time per call
                   (``top_device_ops``: name, µs and count per call); a row
                   of at most ``ORDER_OPS`` device operations a call also
                   lists the last call's in device order
                   (``device_ops_in_order``: name and µs), which tells the
                   input copies, each stage's kernels and the output clone
                   of a replay apart; ``captured``
                   rows: the same rings through ``extract_depth_batch_jit``
                   (one graph replay a call);
  ab               the two modes alternated in one process, pairs of
                   timed runs, medians in ms per call;
  paths            the same profile, as shipped, for stage 6 (the shipped
                   RANSAC ini through ``extract_depth_batch`` at B=8, and in
                   the ``_captured`` row through ``extract_depth_batch_jit``,
                   which replays stages 1-6 as one graph), the
                   SLAM stack (``PlaneSlam.process_frame`` on a warped
                   TUM sequence at 640x480, its step eager and, in the
                   ``_captured`` row, replayed; then ``refine(iterations=10)``
                   and ``optimize_trajectory()`` on its keyframes, op by op
                   (``graphs.eager_backends``) and, in the ``_captured``
                   rows, as the graphs they replay), the
                   720p primitives (1280x720 P=8: ``extract_primitives``
                   eager, and ``process_primitives``, which replays, in the
                   ``_captured`` row) and the PNG sequence
                   (``examples.process_sequence`` streaming 8 warped TUM
                   frames through the native ``SequenceLoader``);
  stages           per path, the ranges that ``profiling.annotate`` opens
                   around each stage: launches (CUDA runtime launch, copy
                   and set calls made inside the range) and host ms per
                   call, and for each stage its launches op by op (the
                   torch operation that made each call). A replay has no
                   ranges: the eager rows hold these counts.

The last line is a JSON object with every number above.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from deplex_tpu_torch import Config, PlaneExtractor, PlaneSlam
from deplex_tpu_torch.ops import cellstats, eigh3x3, histogram
from deplex_tpu_torch.examples.process_sequence import process_sequence, sequence_paths
from deplex_tpu_torch.parallel.batch import extract_depth_batch, extract_depth_batch_jit
from deplex_tpu_torch.pipeline import (backproject_device, depth_tensor, extract_planes_from_depth,
                                       extract_primitives)
from deplex_tpu_torch.tools.graphs import eager_backends
from deplex_tpu_torch.tools.make_sequence import write_sequence
from deplex_tpu_torch.utils import DepthImage, read_intrinsics
from deplex_tpu_torch.utils.scenes import hires_scene
from deplex_tpu_torch.utils.warp import render_sequence, smooth_trajectory

DATA = pathlib.Path(__file__).resolve().parents[2] / "data"
_F64_USERS = (eigh3x3, cellstats, histogram)


def _float32_direct(fn, *args):
    return fn(*args)


@contextlib.contextmanager
def mode(name: str):
    """``f64``: the shipped path; ``f32``: torch's float32 functions in
    place of ``f64_rounded`` in every plain stage."""
    if name == "f64":
        yield
        return
    saved = [m.f64_rounded for m in _F64_USERS]
    for m in _F64_USERS:
        m.f64_rounded = _float32_direct
    try:
        yield
    finally:
        for m, f in zip(_F64_USERS, saved):
            m.f64_rounded = f


def transcendentals(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(100_000, generator=g) * 2 - 1)
    y = (torch.rand(100_000, generator=g) * 2 - 1)
    pos = x.abs() * 1e3
    cases = {"atan2": (torch.atan2, x, y), "cos": (torch.cos, 4 * x),
             "sin": (torch.sin, 4 * x), "acos": (torch.acos, x), "sqrt": (torch.sqrt, pos)}
    out = {}
    for name, (fn, *args) in cases.items():
        for tag, f in (("f32", _float32_direct), ("f64", eigh3x3.f64_rounded)):
            card = f(fn, *(a.to(dev) for a in args)).cpu()
            cpu = f(fn, *args)
            out[f"{name}_{tag}"] = float((card != cpu).float().mean())
    return out


def card_vs_cpu(dev, frames) -> dict:
    """Pixels differing between the card and the CPU, through the eager
    function (a recorded graph would keep the mode it was recorded in)."""
    out = {}
    for m in ("f64", "f32"):
        with mode(m):
            for name, img, K, cfg in frames:
                card, cpu = (extract_planes_from_depth(depth_tensor(img.data, d), K, config=cfg)
                             .cpu() for d in (dev, "cpu"))
                out[f"{name}_{m}"] = int((card != cpu).sum())
    return out


def _busy_us(events) -> float:
    """Union of the device intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -float("inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


# The ranges pipeline.py opens with profiling.annotate, and the CUDA runtime
# calls that put work on the device.
STAGE_RANGES = ("cell_grid", "region_growing", "merge", "labels", "refinement", "cylinders")
# Kernels (by name) listed in a row's top_device_ops.
TOP_OPS = 12
# The most device operations a call for which a row lists them in order.
ORDER_OPS = 64
_RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset",
                  "cuMemcpy", "cuMemset", "cudaGraphLaunch", "cuGraphLaunch")


def _stage_of(e) -> str | None:
    while e is not None:
        if e.name in STAGE_RANGES:
            return e.name
        e = e.cpu_parent
    return None


def stage_breakdown(events, calls: int) -> dict:
    """Per annotated stage: runtime launches and host ms per call, and the
    launches by the torch operation that made them."""
    out = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name in STAGE_RANGES:
            row = out.setdefault(e.name, {"launches": 0, "host_ms": 0.0, "ops": {}})
            row["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3 / calls
        elif e.name.startswith(_RUNTIME_CALLS):
            stage = _stage_of(e)
            if stage is not None:
                row = out.setdefault(stage, {"launches": 0, "host_ms": 0.0, "ops": {}})
                row["launches"] += 1
                op = e.cpu_parent.name if e.cpu_parent is not None else e.name
                row["ops"][op] = row["ops"].get(op, 0) + 1
    for row in out.values():
        row["launches"] /= calls
        row["ops"] = {k: v / calls for k, v in sorted(row["ops"].items(), key=lambda kv: -kv[1])}
    return out


def profile(call, calls: int) -> dict:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        prof_wall_us = 1e6 * (time.perf_counter() - t0)
    # The annotate ranges also show on the device timeline, as spans from
    # their first to their last kernel: they are not device work.
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.name not in STAGE_RANGES]
    busy = _busy_us(device)
    by_name = {}
    for e in device:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.end - e.time_range.start
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    runtime = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name.startswith(_RUNTIME_CALLS))
    per_call = len(device) // calls
    order = {}
    if len(device) % calls == 0 and per_call <= ORDER_OPS:
        last = sorted(device, key=lambda e: e.time_range.start)[-per_call:]
        order = {"device_ops_in_order": [
            [e.name[:100], round(e.time_range.end - e.time_range.start, 2)] for e in last]}
    return {"runtime_launches_per_call": runtime / calls,
            "device_ops_per_call": len(device) / calls,
            "device_busy_ms_per_call": busy / 1e3 / calls,
            "device_busy_share": busy / prof_wall_us,
            "wall_ms_per_call": wall_ms,
            "top_device_ops": [{"name": name[:160], "us_per_call": us / calls,
                                "count_per_call": n / calls} for name, (us, n) in top],
            "stages": stage_breakdown(prof.events(), calls), **order}


def ab(call, pairs: int, reps: int) -> dict:
    times = {"f64": [], "f32": []}
    for _ in range(pairs):
        for m in times:
            with mode(m):
                call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
                times[m].append(1e3 * (time.perf_counter() - t0) / reps)
    return {"f64_median_ms": float(np.median(times["f64"])),
            "f32_median_ms": float(np.median(times["f32"])),
            "f64_faster_pairs": int(sum(a < b for a, b in zip(times["f64"], times["f32"]))),
            "pairs": pairs}


def eagerly(slam, call):
    """call() with `slam`'s backends op by op (``graphs.eager_backends``)."""
    def run():
        with eager_backends(slam):
            return call()
    return run


def path_calls(dev, tum, K_tum, work: pathlib.Path, only=None) -> dict:
    """One call each of stage 6 at B=8, of the SLAM stack's three entry
    points (the backends eager and captured), of the 720p primitives and of
    the PNG-sequence stream (only those named in `only`, when given); the
    tracker first runs 20 frames of a 34-frame sequence, and each profiled
    process_frame takes the next frame."""
    cfg_ransac = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini"))
    ring8 = depth_tensor(np.broadcast_to(tum.data, (8, tum.height, tum.width)), dev)
    ransac = {"ransac_b8": lambda: extract_depth_batch(ring8, K_tum, cfg_ransac),
              "ransac_b8_captured": lambda: extract_depth_batch_jit(ring8, K_tum,
                                                                    config=cfg_ransac)}
    if only is not None and set(only) <= set(ransac):
        return {name: call for name, call in ransac.items() if name in only}
    K = np.asarray(K_tum, np.float32)
    clouds = [backproject_device(depth_tensor(np.clip(np.round(d), 0, 65535).astype(
        np.uint16), dev), torch.as_tensor(K))
        for d in render_sequence(tum.data, K, smooth_trajectory(34, seed=0))]
    trackers = {}
    for name in ("eager", "captured"):
        slam = PlaneSlam(tum.height, tum.width,
                         Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini")),
                         max_landmarks=128, odom_iterations=10, device=dev)
        if name == "eager":
            slam._frame_fn = slam._frame_step     # the step op by op, with its ranges
        frames = iter(clouds)
        for _ in range(20):
            slam.process_frame(next(frames))
        trackers[name] = (slam, frames)
    slam, frames = trackers["captured"]
    hi_pts, hi_h, hi_w = hires_scene()
    hi_cfg = Config(patch_size=8, max_planes=32, min_region_growing_cells_activated=3,
                    min_region_growing_candidate_size=3, max_region_growing_rounds=64)
    hires = PlaneExtractor(hi_h, hi_w, hi_cfg, device=dev)
    hi_cfg = hi_cfg.replace(cylinder_extraction=True)

    def primitives_eager():
        """What process_primitives does, through the eager function."""
        out = extract_primitives(torch.from_numpy(hi_pts).to(dev), image_height=hi_h,
                                 image_width=hi_w, config=hi_cfg)
        return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else type(v)(*(f.cpu().numpy() for f in v))) for k, v in out.items()}
    write_sequence(work / "seq", str(DATA / "tum" / "1341848230.910894.png"),
                   str(DATA / "configs" / "TUM_fr3_long_val.K"), 8)
    paths = sequence_paths(work / "seq")
    cfg_tum = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini"))
    eager_slam, eager_frames = trackers["eager"]
    calls = {**ransac,
             "slam_process_frame": lambda: eager_slam.process_frame(next(eager_frames)),
             "slam_process_frame_captured": lambda: slam.process_frame(next(frames)),
             "slam_refine10": eagerly(slam, lambda: slam.refine(iterations=10)),
             "slam_refine10_captured": lambda: slam.refine(iterations=10),
             "slam_optimize_trajectory": eagerly(slam, slam.optimize_trajectory),
             "slam_optimize_trajectory_captured": slam.optimize_trajectory,
             "primitives_720p": primitives_eager,
             "primitives_720p_captured": lambda: hires.process_primitives(hi_pts),
             "sequence_8_frames": lambda: process_sequence(paths, K_tum, cfg_tum, device=dev)}
    return {name: call for name, call in calls.items() if only is None or name in only}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", type=lambda v: v.split(","), default=None, metavar="ROW,...",
                    help="profile only these rows (e.g. captured_b64,ransac_b8_captured) and "
                         "skip the transcendentals, card_vs_cpu and ab phases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_path: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print("[gpu]", gpu, flush=True)
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K_tum = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    icl = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    K_icl = read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))
    cfg_tum = Config()
    cfg_icl = Config.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    rng = np.random.default_rng(0)

    def ring(B):
        return [depth_tensor(np.stack([np.roll(tum.data, tuple(rng.integers(0, 8, 2)), (0, 1))
                                       for _ in range(B)]), dev) for _ in range(2)]

    only = args.only
    result = {"gpu": gpu}
    if only is None:
        result["transcendentals"] = transcendentals(dev)
        print("[transcendentals]", json.dumps(result["transcendentals"]), flush=True)
        result["card_vs_cpu_pixels"] = card_vs_cpu(
            dev, [("tum", tum, K_tum, cfg_tum), ("icl", icl, K_icl, cfg_icl)])
        print("[card_vs_cpu]", json.dumps(result["card_vs_cpu_pixels"]), flush=True)

    calls = {}
    for B in (64, 1):
        bufs = itertools.cycle(ring(B))
        calls[B] = lambda bufs=bufs: extract_depth_batch(next(bufs), K_tum, cfg_tum)
    result["profile"] = {}
    for m in ("f64", "f32"):
        for B, call in calls.items():
            if only is None or f"{m}_b{B}" in only:
                with mode(m):
                    row = profile(call, calls=5)
                result["profile"][f"{m}_b{B}"] = row
                print(f"[profile] mode={m} batch={B}", json.dumps(row), flush=True)
    for B in calls:          # the same rings through the compiled entry (one replay a call)
        if only is None or f"captured_b{B}" in only:
            bufs = itertools.cycle(ring(B))
            row = profile(lambda bufs=bufs: extract_depth_batch_jit(next(bufs), K_tum,
                                                                    config=cfg_tum), calls=5)
            result["profile"][f"captured_b{B}"] = row
            print(f"[profile] mode=captured batch={B}", json.dumps(row), flush=True)
    if only is None:
        result["ab"] = {f"b{B}": ab(call, pairs=10, reps=10) for B, call in calls.items()}
        print("[ab]", json.dumps(result["ab"]), flush=True)
    result["paths"] = {}
    with tempfile.TemporaryDirectory(prefix="profile_path_") as tmp:
        for name, call in path_calls(dev, tum, K_tum, pathlib.Path(tmp), only).items():
            result["paths"][name] = profile(call, calls=5)
            print(f"[paths] {name}", json.dumps(result["paths"][name]), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
