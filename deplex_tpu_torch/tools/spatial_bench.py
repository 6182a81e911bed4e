"""What row-sharding one frame costs, against one process, at 1, 2, 4... ranks.

Port of the reference package's ``scripts/spatial_bench.py``.
``parallel.spatial.extract_planes_spatial`` splits one frame's cell rows
over the ranks of a 'space' mesh (one all_gather of the cell table; K2, K3
and the rasterization on every rank). For each rank count of ``--ranks``,
``parallel.launcher`` starts that many ranks of ``parallel.verify --spatial``
on every case's frame; each rank extracts a frame once (labels and launches
kept), then times ``--repeats`` more calls (host clock, each ending in a
device sync; the median). One process times ``PlaneExtractor.process`` on
the same points. Every rank's labels must equal one process's. The cases:

    tum     the TUM frame, default config (640x480, P=10: 48x64 cells)
    stress  the planes-only 720p room of ``utils.scenes.stress_cloud``,
            P=8, max_planes 32 (90x160 cells); ``--stress-size`` shrinks it

On a card each rank takes card LOCAL_RANK % device_count: with at least as
many cards as the largest rank count every run is NCCL, else every run is
gloo (ranks then share a card; NCCL refuses two ranks on one).
``--device cpu`` runs gloo CPU ranks, the counterpart of the reference's
fake-device mesh mode. Reports microseconds per frame for each rank and
the bytes each rank gathers.

    python -m deplex_tpu_torch.tools.spatial_bench [--ranks 1,2] [--cases tum,stress]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import tempfile

import numpy as np

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import PLANE_KERNELS
from deplex_tpu_torch.parallel.verify import wall_ms
from deplex_tpu_torch.tools._common import (TUM_K, TUM_PNG, card_info, device_arg,
                                            launch_workers, sweep_backend, write_report)

CASES = ("tum", "stress")


def case_inputs(name: str, stress_size=(720, 1280)):
    """(points (H*W, 3) float32, H, W, Config) of a case."""
    if name == "tum":
        from deplex_tpu_torch.utils import DepthImage, read_intrinsics

        img = DepthImage(str(TUM_PNG))
        return img.transform_to_pcd(read_intrinsics(str(TUM_K))), img.height, img.width, Config()
    if name == "stress":
        from deplex_tpu_torch.utils.scenes import stress_cloud

        H, W = stress_size
        return stress_cloud(H, W), H, W, Config(patch_size=8, max_planes=32)
    raise ValueError(f"unknown case {name!r}; the cases are {CASES}")


def _size(text: str) -> tuple[int, int]:
    h, w = (int(x) for x in text.lower().split("x"))
    return h, w


def run(device=None, ranks=(1, 2), cases=CASES, repeats: int = 5,
        stress_size=(720, 1280), timeout: float = 600.0) -> dict:
    from deplex_tpu_torch import PlaneExtractor
    from deplex_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    report = {**card_info(dev), "repeats": repeats, "protocol": "median host ms of a call, "
              "each ending in a device sync, after one call", "rows": []}
    single = {}
    for name in cases:
        points, H, W, cfg = case_inputs(name, stress_size)
        ex = PlaneExtractor(H, W, cfg, device=dev)
        labels = ex.process(points)
        one_ms = wall_ms(lambda: ex.process(points), dev, repeats)
        single[name] = (points, labels, one_ms, H, W, cfg)
        report["rows"].append({"case": name, "shape": f"{W}x{H}", "patch": cfg.patch_size,
                               "ranks": 0, "single_process_ms": round(one_ms, 3),
                               "us_per_frame": round(1e3 * one_ms, 1),
                               "planes": int(labels.max())})
    be = sweep_backend(dev, ranks)
    ok = True
    with tempfile.TemporaryDirectory(prefix="spatial_bench_") as tmp:
        frames = [pathlib.Path(tmp) / f"{name}.npz" for name in cases]
        for path, name in zip(frames, cases):
            points, _, _, H, W, cfg = single[name]
            np.savez(path, points=points, height=H, width=W,
                     config=json.dumps(dataclasses.asdict(cfg)))
        runs = {n: launch_workers("deplex_tpu_torch.parallel.verify",
                                  ["--spatial", *frames, "--time-reps", repeats], n, dev, be,
                                  timeout) for n in ranks}
    for n, outs in runs.items():
        for name in cases:
            _, labels, one_ms, H, W, cfg = single[name]
            equal = [bool(np.array_equal(o[f"labels_{name}"], labels)) for o in outs]
            launches = {k: [int(o[f"launches_{name}_{k}"]) for o in outs]
                        for k in PLANE_KERNELS}
            ms = [float(o[f"spatial_ms_{name}"]) for o in outs]
            row = {"case": name, "shape": f"{W}x{H}", "patch": cfg.patch_size, "ranks": n,
                   "backend": be, "devices": [str(o["device"]) for o in outs],
                   "rank_ms": [round(x, 3) for x in ms],
                   "us_per_frame_per_rank": [round(1e3 * x, 1) for x in ms],
                   "over_single_process": round(max(ms) / one_ms, 3),
                   "gathered_bytes": int(outs[0][f"gathered_bytes_{name}"]),
                   "labels_equal_single": equal, "launches": launches,
                   "jax_imported": any(bool(o["jax_imported"]) for o in outs)}
            ok = ok and all(equal) and not row["jax_imported"]
            report["rows"].append(row)
    report["pass"] = ok
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--ranks", default="1,2", help="comma-separated rank counts")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--stress-size", default="720x1280", help="HxW of the stress case")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a launch may take")
    ap.add_argument("--out", default=None, help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    report = run(args.device, [int(n) for n in args.ranks.split(",")],
                 [c for c in args.cases.split(",") if c], args.repeats,
                 _size(args.stress_size), args.timeout)
    print(json.dumps(report))
    if args.out:
        write_report(args.out, report)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
