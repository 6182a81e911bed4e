"""720p planes-only throughput (BASELINE.json config 4) on one device.

Port of the reference package's ``scripts/bench_720p.py``. The scene is
its floor + back wall + side wall room with 2 mm noise (seed 0), rendered
to uint16 depth at 1280x720 (``utils.scenes.stress_depth``), extracted at
``Config(patch_size=8, max_planes=32)`` (90x160 cells). A ring of G x B
frames rolled by 0-7 rows and columns (seed 1) lives on the device (G=4,
B=8: 59 MB of uint16). After a warm-up over the ring, ``extract_depth_batch``
runs on batch i % G for every timed call, and every timed call's labels are
checked against the reference bench's bounds: 2-16 planes and more than
half of the pixels labelled (their per-frame summaries stay on the device
until the clock stops). Times are CUDA events on the card (the host clock
on the CPU); frames/s and microseconds per frame.

    python -m deplex_tpu_torch.tools.bench_720p [--batch 8] [--ring 4] [--repeats 256]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.tools._common import card_info, device_arg, mean_ms, rolled_ring, write_report

PLANES_MIN, PLANES_MAX, LABELLED_MIN = 2, 16, 0.5


def run(device=None, batch: int = 8, ring: int = 4, repeats: int = 256, height: int = 720,
        width: int = 1280) -> dict:
    from deplex_tpu_torch import kernels
    from deplex_tpu_torch.parallel.batch import extract_depth_batch
    from deplex_tpu_torch.pipeline import depth_tensor, resolve_device
    from deplex_tpu_torch.utils.scenes import stress_depth

    dev = resolve_device(device)
    B, G, H, W = batch, ring, height, width
    cfg = Config(patch_size=8, max_planes=32)
    depth, K = stress_depth(H, W)
    frames = depth_tensor(rolled_ring(depth, G * B, seed=1).reshape(G, B, H, W), dev)
    n_iters = max(repeats // B, 1)
    planes = torch.zeros((n_iters, B), dtype=torch.int32, device=dev)
    labelled = torch.zeros((n_iters, B), dtype=torch.int64, device=dev)

    turn = itertools.count()

    def call():
        i = next(turn)
        labels = extract_depth_batch(frames[i % G], K, cfg)
        planes[i] = labels.amax(1)
        labelled[i] = (labels > 0).sum(1)

    for g in range(G):                                  # warm-up over the ring
        extract_depth_batch(frames[g], K, cfg)
    kernels.reset_launch_counts()
    ms = mean_ms(call, n_iters, warmup=0, device=dev)
    launches = kernels.launch_counts()
    planes, labelled = planes.cpu(), labelled.cpu()
    ok = bool(((planes >= PLANES_MIN) & (planes <= PLANES_MAX)).all()
              and (labelled > LABELLED_MIN * H * W).all())
    fps = 1e3 * B / ms
    return {**card_info(dev),
            "metric": "stress_720p_frames_per_s", "frames_per_s": round(fps, 1),
            "us_per_frame": round(1e3 * ms / B, 3), "batch": B, "ring": G,
            "timed_calls": n_iters, "frame": f"{W}x{H}",
            "config": "patch 8, max_planes 32 (BASELINE.json config 4)",
            "scene": "floor + back wall + side wall, 2 mm noise (scripts/bench_720p.py), "
                     "rolled ring of distinct frames resident on the device",
            "ring_bytes": int(frames.numel() * 2), "launches": launches,
            "planes_min": int(planes.min()), "planes_max": int(planes.max()),
            "labelled_share_min": round(float(labelled.min()) / (H * W), 4),
            "bounds": f"{PLANES_MIN}-{PLANES_MAX} planes and > {LABELLED_MIN} of the pixels "
                      "labelled, on every timed frame",
            "pass": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ring", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=256, help="frames timed in all")
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--out", default=None, help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    report = run(args.device, args.batch, args.ring, args.repeats, args.height, args.width)
    print(json.dumps(report))
    if args.out:
        write_report(args.out, report)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
