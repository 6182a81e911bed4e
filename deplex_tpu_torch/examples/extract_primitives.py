"""Planes + cylinders demo (CAPE's full primitive set).

Port of the reference package's ``examples/python/extract_primitives.py``:
the extended pipeline on the synthetic scene of a cylinder in front of a
wall (240x320, ``utils.scenes.cylinder_scene``), printing the fitted
primitives.

    python -m deplex_tpu_torch.examples.extract_primitives
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from deplex_tpu_torch import Config, PlaneExtractor
    from deplex_tpu_torch.utils.scenes import cylinder_scene

    pts, H, W = cylinder_scene()
    cfg = Config(patch_size=8, cylinder_extraction=True, max_planes=16,
                 min_region_growing_cells_activated=3,
                 min_region_growing_candidate_size=3,
                 max_region_growing_rounds=64,
                 depth_discontinuity_threshold=600.0)
    out = PlaneExtractor(H, W, cfg, device=args.device).process_primitives(pts)
    cyl = out["cylinders"]
    n = int(cyl.nr_cylinders)
    print(f"planes: {int(out['plane_labels'].max())}, cylinders: {n}")
    for i in range(n):
        print(f"  cylinder {i + 1}: radius={float(cyl.radius[i]):.1f}mm "
              f"axis={np.asarray(cyl.axis[i]).round(3)} "
              f"rmse={float(cyl.rmse[i]):.2f}mm "
              f"cells={int(cyl.size[i])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
