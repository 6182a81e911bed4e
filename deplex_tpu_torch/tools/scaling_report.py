"""Data-parallel scaling: frames/s and scaling efficiency at 1, 2, 4... ranks.

Port of the reference package's ``scripts/scaling_report.py``. For each
rank count of ``--ranks``, ``parallel.launcher`` starts that many ranks of
this module's worker. Each rank builds ``parallel.batch.ShardedPlaneExtractor``
over a 'data' mesh and calls ``process`` on a batch of
``--frames-per-device`` frames a rank (the TUM frame, back-projected): it
extracts its own slice on its own device and gets the whole batch's labels
back (one all_gather). After a warm-up call and a barrier, ``--repeats``
calls are timed on the host clock; the slowest rank's time gives frames/s.
Every frame's labels must equal one process's. Scaling efficiency is
frames/s over (the first row's frames/s x ranks / its ranks).

With at least as many cards as ranks the group is NCCL and each rank has a
card; with fewer, every rank count runs gloo and ranks share a card: then
the efficiency column measures host contention and the collectives' host
copies, not what more cards would give.
``--device cpu`` runs gloo CPU ranks.

    python -m deplex_tpu_torch.tools.scaling_report [--ranks 1,2] [--frames-per-device 8]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import PLANE_KERNELS
from deplex_tpu_torch.tools._common import (TUM_K, TUM_PNG, card_info, device_arg,
                                            launch_workers, sweep_backend, write_report)


def _clouds(image, intrinsics, frames: int) -> np.ndarray:
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    img = DepthImage(str(image))
    cloud = img.transform_to_pcd(read_intrinsics(str(intrinsics)))
    return np.array(np.broadcast_to(cloud, (frames,) + cloud.shape)), img


def worker(args) -> int:
    """One rank: warm-up, barrier, timed calls; writes proc<rank>.npz
    under args.out."""
    import torch.distributed as dist

    from deplex_tpu_torch import kernels
    from deplex_tpu_torch.parallel.batch import ShardedPlaneExtractor
    from deplex_tpu_torch.parallel.distributed import initialize, make_mesh

    dev = initialize()
    if dev is None:
        raise SystemExit("scaling_report --worker runs under parallel.launcher")
    world, rank = dist.get_world_size(), dist.get_rank()
    clouds, img = _clouds(args.image, args.intrinsics, args.frames_per_device * world)
    ex = ShardedPlaneExtractor(img.height, img.width, Config(), mesh=make_mesh("data"),
                               device=dev)
    labels = ex.process(clouds)                       # warm-up; its labels are checked
    kernels.reset_launch_counts()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(args.repeats):
        last = ex.process(clouds)
    seconds = time.perf_counter() - t0
    np.savez(pathlib.Path(args.out) / f"proc{rank}.npz", labels=labels, last=last,
             seconds=seconds, device=str(dev), backend=dist.get_backend(),
             jax_imported="jax" in sys.modules,
             **{f"launches_{k}": n for k, n in kernels.launch_counts().items()})
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run(device=None, ranks=(1, 2), frames_per_device: int = 8, repeats: int = 10,
        image=TUM_PNG, intrinsics=TUM_K,
        timeout: float = 600.0) -> dict:
    from deplex_tpu_torch import PlaneExtractor
    from deplex_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    clouds, img = _clouds(image, intrinsics, 1)
    single = PlaneExtractor(img.height, img.width, Config(), device=dev).process(clouds[0])
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    be = sweep_backend(dev, ranks)
    rows, ok, base = [], True, None
    for n in ranks:
        outs = launch_workers("deplex_tpu_torch.tools.scaling_report",
                              ["--worker", "--frames-per-device", frames_per_device,
                               "--repeats", repeats,
                               "--image", image, "--intrinsics", intrinsics],
                              n, dev, be, timeout)
        B = frames_per_device * n
        seconds = max(float(o["seconds"]) for o in outs)
        equal = all(np.array_equal(o[k], np.broadcast_to(single, (B, single.size)))
                    for o in outs for k in ("labels", "last"))
        fps = B * repeats / seconds
        base = base or (fps, n)
        row = {"ranks": n, "backend": be, "devices": [str(o["device"]) for o in outs],
               "batch": B, "frames_per_s": round(fps, 1),
               "launches_per_rank": {k: [int(o[f"launches_{k}"]) for o in outs]
                                     for k in PLANE_KERNELS},
               "labels_equal_single": equal,
               "jax_imported": any(bool(o["jax_imported"]) for o in outs)}
        row["scaling_efficiency"] = round(fps / (base[0] * n / base[1]), 3)
        ok = ok and equal and not row["jax_imported"]
        rows.append(row)
    report = {**card_info(dev), "cards": cards, "frames_per_device": frames_per_device,
              "repeats": repeats, "protocol": "host clock over the repeats after a warm-up "
              "call and a barrier; the slowest rank", "rows": rows, "pass": ok}
    if cards < max(ranks):
        report["note"] = (
            f"{max(ranks)} ranks on {cards or 'no'} card(s): ranks share a device, so the "
            "efficiency column measures host contention and the gloo collectives' host "
            "copies, not the scaling more cards would give. The extraction has no collective "
            "(each rank extracts its own frames; one all_gather returns the labels), so a "
            "rank with a card of its own runs at the one-rank rate.")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--ranks", default="1,2", help="comma-separated rank counts")
    ap.add_argument("--frames-per-device", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--image", default=str(TUM_PNG))
    ap.add_argument("--intrinsics", default=str(TUM_K))
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a launch may take")
    ap.add_argument("--out", default=None,
                    help="also write the report here (JSON); a worker's directory")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    report = run(args.device, [int(n) for n in args.ranks.split(",")], args.frames_per_device,
                 args.repeats, args.image, args.intrinsics, args.timeout)
    print(json.dumps(report))
    if args.out:
        write_report(args.out, report)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
