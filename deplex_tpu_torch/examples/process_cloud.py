"""Single-frame plane extraction example.

Port of the reference package's ``examples/python/process_cloud.py``: load
the TUM sample depth frame, extract planes from its organized cloud, print
the plane count and the time per frame over repeated runs.

    python -m deplex_tpu_torch.examples.process_cloud --runs 5
"""

from __future__ import annotations

import argparse
import pathlib
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--image", default=str(ROOT / "data/tum/1341848230.910894.png"))
    parser.add_argument("--intrinsics", default=str(ROOT / "data/configs/TUM_fr3_long_val.K"))
    parser.add_argument("--config", default=str(ROOT / "data/configs/TUM_fr3_long_val.ini"))
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from deplex_tpu_torch import Config, PlaneExtractor
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    config = Config.from_ini(args.config)
    image = DepthImage(args.image)
    pcd = image.transform_to_pcd(read_intrinsics(args.intrinsics))

    algorithm = PlaneExtractor(image.height, image.width, config, device=args.device)
    labels = algorithm.process(pcd)  # warm-up: kernel build and first launches

    start = time.perf_counter()
    for _ in range(args.runs):
        labels = algorithm.process(pcd)
    elapsed = (time.perf_counter() - start) / max(args.runs, 1)

    print(f"Found planes: {labels.max()}")
    print(f"Elapsed time (mks): {elapsed * 1e6:.0f}")
    print(f"FPS: {1.0 / elapsed:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
