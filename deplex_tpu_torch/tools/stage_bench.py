"""Per-stage time of the batched depth->labels path, each stage on its own.

Port of the reference package's ``scripts/stage_bench.py``. The inputs are
a ring of G batches of B distinct frames (the TUM frame rolled by 0-7 rows
and columns, seed 0), so no two calls in a row read the same buffers; every
stage's inputs are the real intermediates of those frames, computed once.
Each stage is called over the ring ``--repeats`` times after a warm-up and
timed with CUDA events on the card (the host clock on the CPU); a time is
microseconds per frame. The stages, in the order the path runs them:

    k1_cell_moments       K1 (csrc/cellstats.cu) through its wrapper, the
                          13 moment planes
    cell_finalize         csrc/cellfinal.cu: eigensolve, gates, normal bins,
                          packed edges
    k2_grow_rounds        K2 (csrc/growing.cu), the rounds loop
    round_finalize        csrc/rounds.cu: per-round sums, plane fits, gates,
                          slots, cell labels
    k3_merge_planes       K3 (csrc/merge.cu): adjacency and merge, one launch
    pixel_labels          csrc/labels.cu: cell labels to int32 pixel labels

Each stage's share is of the six stages' sum; ``whole_path`` times
``extract_depth_batch`` over the same ring and ``whole_path_identical``
over a ring of the unrolled frame (the reference bench's input). On the CPU
the kernel rows time the plain twins.

    python -m deplex_tpu_torch.tools.stage_bench [--batch 8] [--ring 4] [--repeats 50]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.tools._common import (TUM_K, TUM_PNG, card_info, device_arg, mean_ms,
                                            rolled_ring, write_report)

STAGES = ("k1_cell_moments", "cell_finalize", "k2_grow_rounds", "round_finalize",
          "k3_merge_planes", "pixel_labels")


def run(device=None, batch: int = 8, ring: int = 4, repeats: int = 50, image=TUM_PNG,
        intrinsics=TUM_K) -> dict:
    from deplex_tpu_torch.kernels import cellfinal as k_final
    from deplex_tpu_torch.kernels import cellstats as k_cells
    from deplex_tpu_torch.kernels import growing as k_grow
    from deplex_tpu_torch.kernels import labels as k_labels
    from deplex_tpu_torch.kernels import merge as k_merge
    from deplex_tpu_torch.kernels import rounds as k_rounds
    from deplex_tpu_torch.ops.cellstats import patch_size
    from deplex_tpu_torch.parallel.batch import extract_depth_batch
    from deplex_tpu_torch.pipeline import (depth_tensor, full_float32, intrinsics_tensor,
                                           resolve_device)
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    dev = resolve_device(device)
    cfg = Config()
    img = DepthImage(str(image))
    K = intrinsics_tensor(read_intrinsics(str(intrinsics)), dev)
    B, G, H, W = batch, ring, img.height, img.width
    P = patch_size(H, W, cfg)
    frames = rolled_ring(img.data, G * B, seed=0).reshape(G, B, H, W)
    depth = [depth_tensor(f, dev) for f in frames]
    identical = [depth_tensor(np.broadcast_to(img.data, (B, H, W)), dev) for _ in range(G)]

    def over_ring(fn):
        turn = itertools.count()
        return lambda: fn(next(turn) % G)

    with full_float32(dev):
        # The real intermediates of every batch of the ring.
        planes = [k_cells.cell_moment_planes(d, K, cfg) for d in depth]
        cells = [k_final.cell_finalize(p, P, cfg) for p in planes]
        loops = [k_grow.grow_rounds(c, cfg) for c in cells]
        segs = [k_rounds.round_finalize(*loop, c.stats, cfg)[1:]
                for loop, c in zip(loops, cells)]
        merged = [k_merge.merge_planes(lm, seg, cfg)[0] for lm, seg in segs]
        calls = {
            "k1_cell_moments": lambda g: k_cells.cell_moment_planes(depth[g], K, cfg),
            "cell_finalize": lambda g: k_final.cell_finalize(planes[g], P, cfg),
            "k2_grow_rounds": lambda g: k_grow.grow_rounds(cells[g], cfg),
            "round_finalize": lambda g: k_rounds.round_finalize(*loops[g], cells[g].stats, cfg),
            "k3_merge_planes": lambda g: k_merge.merge_planes(*segs[g], cfg),
            "pixel_labels": lambda g: k_labels.pixel_labels(segs[g][0], merged[g], H, W, P),
            "whole_path": lambda g: extract_depth_batch(depth[g], K, cfg),
            "whole_path_identical": lambda g: extract_depth_batch(identical[g], K, cfg),
        }
        us = {name: 1e3 * mean_ms(over_ring(fn), repeats, warmup=G, device=dev) / B
              for name, fn in calls.items()}
        found = torch.stack([extract_depth_batch(d, K, cfg).amax(1) for d in depth])
    total = sum(us[s] for s in STAGES)
    return {**card_info(dev), "batch": B, "ring": G, "repeats": repeats,
            "frame": f"{W}x{H}", "patch": P,
            "protocol": "each stage on its own over a ring of G batches of rolled frames, "
                        "after a warm-up; CUDA events on the card, the host clock on the CPU",
            "us_per_frame": {k: round(v, 3) for k, v in us.items()},
            "share_of_stage_sum": {s: round(us[s] / total, 4) for s in STAGES},
            "stage_sum_us_per_frame": round(total, 3),
            "frames_per_s": round(1e6 / us["whole_path"], 1),
            "planes_min": int(found.min()), "planes_max": int(found.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ring", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=50)
    ap.add_argument("--image", default=str(TUM_PNG))
    ap.add_argument("--intrinsics", default=str(TUM_K))
    ap.add_argument("--out", default=None, help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    report = run(args.device, args.batch, args.ring, args.repeats, args.image, args.intrinsics)
    width = max(map(len, report["us_per_frame"]))
    for name, v in report["us_per_frame"].items():
        share = report["share_of_stage_sum"].get(name)
        print(f"{name:{width}s} {v:12.3f} us/frame" + (f"  {100 * share:5.1f}%" if share else ""))
    print(json.dumps(report))
    if args.out:
        write_report(args.out, report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
