"""Streaming-sequence plane extraction example.

Port of the reference package's ``examples/python/process_sequence.py``:
process every ``*.png`` of a directory in sorted order, streamed through the
native ``SequenceLoader`` (C++ threads decode ahead), and report the
min/max/mean per-frame latency including the load; with ``--batch B``,
frames go B at a time through ``BatchDepthExtractor`` (each frame's latency
is its batch's share).

    python -m deplex_tpu_torch.examples.process_sequence DIR [MAX_FRAMES] [--batch 8]
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]


def sequence_paths(dataset_dir, max_frames: int = 0) -> list[pathlib.Path]:
    paths = sorted(pathlib.Path(dataset_dir).glob("*.png"))
    if max_frames:
        paths = paths[:max_frames]
    if not paths:
        raise SystemExit(f"no *.png frames in {dataset_dir}")
    return paths


def process_sequence(paths, K, config, batch: int = 0, device=None) -> dict:
    """Extract planes from every frame at `paths` (loaded by SequenceLoader).
    Returns {"labels": [(H*W,) labels per frame], "latency_s": [per frame]}."""
    from deplex_tpu_torch import PlaneExtractor
    from deplex_tpu_torch.native import SequenceLoader
    from deplex_tpu_torch.parallel.batch import BatchDepthExtractor
    from deplex_tpu_torch.utils.depth_image import png16_shape

    H, W = png16_shape(paths[0])
    zeros = np.zeros((H, W), np.uint16)
    loader = SequenceLoader([str(p) for p in paths], W, H)
    labels, latency = [], []
    try:
        if batch <= 1:
            algorithm = PlaneExtractor(H, W, config, device=device)
            algorithm.process_depth(zeros, K)          # warm-up: kernel build
            while True:
                t0 = time.perf_counter()
                depth = loader.next_depth()
                if depth is None:
                    break
                labels.append(algorithm.process_depth(depth, K))
                latency.append(time.perf_counter() - t0)
        else:
            algorithm = BatchDepthExtractor(H, W, config, batch=batch, device=device)
            algorithm.process(np.broadcast_to(zeros, (batch, H, W)), K)   # warm-up
            while True:
                t0 = time.perf_counter()
                chunk = [d for d in (loader.next_depth() for _ in range(batch)) if d is not None]
                if not chunk:
                    break
                # The last batch is padded by repeating its last frame.
                out = algorithm.process(np.stack(chunk + chunk[-1:] * (batch - len(chunk))), K)
                labels.extend(out[:len(chunk)].astype(np.int32))
                latency.extend([(time.perf_counter() - t0) / len(chunk)] * len(chunk))
    finally:
        loader.close()
    return {"labels": labels, "latency_s": latency}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir", nargs="?", default=str(ROOT / "data/tum"))
    parser.add_argument("max_frames", nargs="?", type=int, default=0)
    parser.add_argument("--config", default=str(ROOT / "data/configs/TUM_fr3_long_val.ini"))
    parser.add_argument("--intrinsics", default=str(ROOT / "data/configs/TUM_fr3_long_val.K"))
    parser.add_argument("--batch", type=int, default=0,
                        help="frames per call (0 = streaming, like the reference)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from deplex_tpu_torch import Config
    from deplex_tpu_torch.utils import read_intrinsics

    out = process_sequence(sequence_paths(args.dataset_dir, args.max_frames),
                           read_intrinsics(args.intrinsics), Config.from_ini(args.config),
                           batch=args.batch, device=args.device)
    lat = np.asarray(out["latency_s"]) * 1e6
    print(f"Processed frames: {len(lat)}")
    print(f"Min elapsed time (mks): {lat.min():.0f}")
    print(f"Max elapsed time (mks): {lat.max():.0f}")
    print(f"Mean elapsed time (mks): {lat.mean():.0f}")
    print(f"FPS: {1e6 / lat.mean():.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
