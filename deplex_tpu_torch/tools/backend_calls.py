#!/usr/bin/env python3
"""The SLAM backends as a running tracker calls them, timed call by call.

    python3 -m deplex_tpu_torch.tools.backend_calls --mode growing|once [--out FILE]
    python3 -m deplex_tpu_torch.tools.backend_calls --compare DIR [DIR ...] [--out FILE]

Run from the repository root on a machine with a CUDA card. Both modes
track ``chip_smoke.py`` [slam]'s sequence: 30 TUM frames warped along
``smooth_trajectory(30, seed=0)``, 640x480, 128 landmarks, 10 odometry
iterations, every frame a keyframe.

  growing  after every ``--every``-th frame (3: K = 3, 6, ..., 30),
           ``refine(iterations=10)`` and then ``optimize_trajectory()``,
           each on the state the last left, and tracking goes on from it:
           an always-on tracker's backends, whose shapes grow with the map;
  once     after the 30 frames, ``refine(iterations=10)`` and
           ``optimize_trajectory()`` once each from the tracked state, as
           ``examples/run_slam.py`` calls them in a process of its own.

Each call's wall ms (the call reads its result back to the host, so it has
ended on the card), their sums, the graphs in the cache at the end (entry,
replays) and the ATE of the final trajectory are printed as one JSON line.

``--compare`` runs each mode in a fresh process for each checkout root
DIR (its ``deplex_tpu_torch`` first on the path), in the order given and
then reversed (A, B, B, A), and prints every run's line and, last, one
JSON object with all of them. The modes use only the API that predates the
compiled backends, so an earlier checkout is timed by the same code.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np


def track_and_call(mode: str, every: int) -> dict:
    import torch

    from deplex_tpu_torch import Config, PlaneSlam, compiled
    from deplex_tpu_torch.pipeline import backproject_device, depth_tensor
    from deplex_tpu_torch.tools._common import DATA, card_info
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics
    from deplex_tpu_torch.utils.warp import render_sequence, smooth_trajectory

    if not torch.cuda.is_available():
        raise SystemExit("backend_calls: no CUDA device")
    dev = torch.device("cuda", 0)
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = np.asarray(read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K")), np.float32)
    poses = smooth_trajectory(30, seed=0)
    seq = [np.clip(np.round(d), 0, 65535).astype(np.uint16)
           for d in render_sequence(tum.data, K, poses)]
    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini"))
    slam = PlaneSlam(tum.height, tum.width, cfg, max_landmarks=128, odom_iterations=10,
                     device=dev)
    Kt = torch.as_tensor(K)
    calls = []

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        calls.append({"call": name, "keyframes": len(slam._keyframes),
                      "ms": 1e3 * (time.perf_counter() - t0)})

    for n, depth in enumerate(seq, 1):
        slam.process_frame(backproject_device(depth_tensor(depth, dev), Kt))
        if mode == "growing" and n % every == 0:
            timed("refine", lambda: slam.refine(iterations=10))
            timed("optimize_trajectory", slam.optimize_trajectory)
    if mode == "once":
        tracked, tracked_map = list(slam.trajectory), slam.map
        timed("refine", lambda: slam.refine(iterations=10))
        slam.trajectory, slam.map = list(tracked), tracked_map
        timed("optimize_trajectory", slam.optimize_trajectory)
    gt_c = np.stack([-R.T @ t for R, t in poses])
    est_c = np.stack([-R.T @ t for R, t in slam.trajectory])
    sums = {name: sum(c["ms"] for c in calls if c["call"] == name)
            for name in ("refine", "optimize_trajectory")}
    return {"mode": mode, "root": str(pathlib.Path(compiled.__file__).parents[1]),
            **card_info(dev), "calls": calls, "sum_ms": sums,
            "total_ms": sum(sums.values()),
            "graphs": [[g.key[0], g.replays] for g in compiled.graphs()],
            "ate_mm": float(np.sqrt(np.mean(np.sum((est_c - gt_c) ** 2, -1))))}


def compare(roots, modes, every: int, timeout: float) -> list:
    """Each mode for each root in a fresh process: roots in order, then
    reversed (``_common.checkout_turns``)."""
    from deplex_tpu_torch.tools._common import checkout_turns, run_in_checkout

    runs = []
    for mode in modes:
        for root in checkout_turns(list(roots)):
            run = {"mode": mode, "root": str(root),
                   **run_in_checkout(root, __file__, ["--mode", mode, "--every", every],
                                     timeout)}
            print(json.dumps(run), flush=True)
            runs.append(run)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("growing", "once"), default="growing")
    ap.add_argument("--every", type=int, default=3, help="frames between backend calls")
    ap.add_argument("--compare", nargs="+", default=None, metavar="DIR",
                    help="checkout roots to time, each mode in a fresh process")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run may take")
    ap.add_argument("--out", default=None, help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    if args.compare:
        runs = compare(args.compare, ("growing", "once"), args.every, args.timeout)
        report = {"runs": runs}
        ok = all(r["returncode"] == 0 for r in runs)
    else:
        report = track_and_call(args.mode, args.every)
        ok = True
    print(json.dumps(report))
    if args.out:
        from deplex_tpu_torch.tools._common import write_report
        write_report(args.out, report)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
