#!/usr/bin/env python3
"""Where the device time goes on each path, and what the float64 route costs.

    python3 -m deplex_tpu_torch.tools.profile_path

Run from the repository root on a machine with a CUDA card. It drives
``extract_depth_batch`` on the TUM frame and prints one line per phase:

  transcendentals  share of 1e5 float32 inputs on which the card and the CPU
                   give other bits, for torch's float32 functions and for
                   the same functions through ``ops.eigh3x3.f64_rounded``;
  card_vs_cpu      pixels whose labels differ between the card and the CPU
                   twins, on TUM (P=10) and ICL (P=4), with the plain stages
                   in each mode (``f64``: as shipped; ``f32``: torch's
                   float32 functions in place of ``f64_rounded``);
  profile          torch.profiler over calls after warm-up, per mode and
                   batch: device operations per call, device busy ms per
                   call and its share of the profiled wall time, and the
                   unprofiled wall ms per call;
  ab               the two modes alternated in one process, pairs of
                   timed runs, medians in ms per call;
  paths            the same profile, as shipped, for stage 6 (the shipped
                   RANSAC ini through ``extract_depth_batch`` at B=8) and
                   the SLAM stack (``PlaneSlam.process_frame`` on a warped
                   TUM sequence at 640x480, then ``refine(iterations=10)``
                   and ``optimize_trajectory()`` on its keyframes).

The last line is a JSON object with every number above.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from deplex_tpu_torch import Config, PlaneExtractor, PlaneSlam
from deplex_tpu_torch.ops import cellstats, eigh3x3, histogram
from deplex_tpu_torch.parallel.batch import extract_depth_batch
from deplex_tpu_torch.pipeline import backproject_device, depth_tensor
from deplex_tpu_torch.utils import DepthImage, read_intrinsics
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
    out = {}
    for m in ("f64", "f32"):
        with mode(m):
            for name, img, K, cfg in frames:
                card = PlaneExtractor(img.height, img.width, cfg, device=dev).process_depth(img.data, K)
                cpu = PlaneExtractor(img.height, img.width, cfg, device="cpu").process_depth(img.data, K)
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
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(device)
    return {"device_ops_per_call": len(device) / calls,
            "device_busy_ms_per_call": busy / 1e3 / calls,
            "device_busy_share": busy / prof_wall_us,
            "wall_ms_per_call": wall_ms}


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


def path_calls(dev, tum, K_tum) -> dict:
    """One call each of stage 6 at B=8 and of the SLAM stack's three entry
    points; the tracker first runs 20 frames of a 34-frame sequence, and
    each profiled process_frame takes the next frame."""
    cfg_ransac = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini"))
    ring8 = depth_tensor(np.broadcast_to(tum.data, (8, tum.height, tum.width)), dev)
    K = np.asarray(K_tum, np.float32)
    frames = iter([backproject_device(depth_tensor(np.clip(np.round(d), 0, 65535).astype(
        np.uint16), dev), torch.as_tensor(K))
        for d in render_sequence(tum.data, K, smooth_trajectory(34, seed=0))])
    slam = PlaneSlam(tum.height, tum.width,
                     Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini")),
                     max_landmarks=128, odom_iterations=10, device=dev)
    for _ in range(20):
        slam.process_frame(next(frames))
    return {"ransac_b8": lambda: extract_depth_batch(ring8, K_tum, cfg_ransac),
            "slam_process_frame": lambda: slam.process_frame(next(frames)),
            "slam_refine10": lambda: slam.refine(iterations=10),
            "slam_optimize_trajectory": slam.optimize_trajectory}


def main() -> int:
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

    result = {"gpu": gpu, "transcendentals": transcendentals(dev)}
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
            with mode(m):
                row = profile(call, calls=5)
            result["profile"][f"{m}_b{B}"] = row
            print(f"[profile] mode={m} batch={B}", json.dumps(row), flush=True)
    result["ab"] = {f"b{B}": ab(call, pairs=10, reps=10) for B, call in calls.items()}
    print("[ab]", json.dumps(result["ab"]), flush=True)
    result["paths"] = {}
    for name, call in path_calls(dev, tum, K_tum).items():
        result["paths"][name] = profile(call, calls=5)
        print(f"[paths] {name}", json.dumps(result["paths"][name]), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
