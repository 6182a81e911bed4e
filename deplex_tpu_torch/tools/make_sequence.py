"""Render a multi-frame 16-bit depth PNG sequence from one depth frame.

Port of the reference package's ``scripts/make_sequence.py``: N frames of
the TUM sample warped along ``utils.warp.smooth_trajectory`` (pose 0 is the
frame itself), written as ``000000.png``... (rounded and clipped to uint16),
with the exact camera-from-world poses in ``trajectory_gt.npz`` (R, t) and
the generation parameters in ``manifest.json``: the layout
``SequenceLoader``, ``examples.process_sequence`` and ``examples.run_slam``
stream. The PNGs are written by ``utils.depth_image.write_png16`` (no PIL).

    python -m deplex_tpu_torch.tools.make_sequence --out /tmp/tum_seq --frames 30
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from deplex_tpu_torch.utils import DepthImage, read_intrinsics
from deplex_tpu_torch.utils.depth_image import write_png16
from deplex_tpu_torch.utils.warp import render_sequence, smooth_trajectory

ROOT = pathlib.Path(__file__).resolve().parents[2]


def sequence_frames(depth0: np.ndarray, K, frames: int, seed: int = 0):
    """(uint16 frames, poses): depth0 warped along smooth_trajectory(frames,
    seed), rounded and clipped as they are written."""
    poses = smooth_trajectory(frames, seed=seed)
    rendered = render_sequence(depth0, np.asarray(K, np.float32), poses)
    return [np.clip(np.round(d), 0, 65535).astype(np.uint16) for d in rendered], poses


def write_sequence(out, image: str, intrinsics: str, frames: int, seed: int = 0) -> list:
    """Write the sequence under `out`; returns its PNG paths in order."""
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    depth, poses = sequence_frames(DepthImage(image).data, read_intrinsics(intrinsics),
                                   frames, seed)
    paths = []
    for i, d in enumerate(depth):
        paths.append(out / f"{i:06d}.png")
        write_png16(paths[-1], d)
    np.savez(out / "trajectory_gt.npz", R=np.stack([R for R, _ in poses]),
             t=np.stack([t for _, t in poses]))
    (out / "manifest.json").write_text(json.dumps({
        "generator": "deplex_tpu_torch.tools.make_sequence",
        "image": str(pathlib.Path(image).resolve()),
        "intrinsics": str(pathlib.Path(intrinsics).resolve()),
        "frames": frames,
        "seed": seed,
    }, indent=2) + "\n")
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--image", default=str(ROOT / "data/tum/1341848230.910894.png"))
    ap.add_argument("--intrinsics", default=str(ROOT / "data/configs/TUM_fr3_long_val.K"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write_sequence(args.out, args.image, args.intrinsics, args.frames, args.seed)
    print(f"{args.frames} frames -> {args.out} (+ trajectory_gt.npz, manifest.json)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
