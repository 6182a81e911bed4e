"""Colour a point cloud by its plane labels and write it as CSV.

Port of the reference package's ``scripts/apply_labels.py`` (the C++
reference's visualization script): a colour per plane id drawn from a
seeded palette, uniform in [0.1, 1) per channel in the order of the sorted
ids, and black for label 0. The coloured cloud is written as CSV rows
``x,y,z,r,g,b`` for an external viewer (no open3d needed).

    python -m deplex_tpu_torch.tools.apply_labels cloud.csv labels.csv --out coloured.csv
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def colorize(points: np.ndarray, labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """(N,) labels -> (N, 3) float colours in [0, 1); label 0 black."""
    rng = np.random.default_rng(seed)
    ids = np.unique(labels)
    palette = {0: np.zeros(3)}
    for i in ids[ids > 0]:
        palette[int(i)] = rng.uniform(0.1, 1.0, 3)
    return np.stack([palette[int(label)] for label in labels])


def main(argv=None) -> int:
    from deplex_tpu_torch.utils import read_pcd_csv

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cloud_csv", help="point cloud CSV (x,y,z a row)")
    ap.add_argument("labels_csv", help="labels CSV (one integer a row)")
    ap.add_argument("--out", required=True, help="the coloured cloud CSV")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    points = read_pcd_csv(args.cloud_csv)
    labels = np.loadtxt(args.labels_csv, dtype=np.int64).reshape(-1)
    if labels.size != points.shape[0]:
        raise SystemExit(f"{labels.size} labels for {points.shape[0]} points")
    np.savetxt(args.out, np.hstack([points, colorize(points, labels, args.seed)]),
               delimiter=",", fmt="%g")
    print(f"coloured {points.shape[0]} points ({int(np.unique(labels[labels > 0]).size)} "
          f"planes) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
