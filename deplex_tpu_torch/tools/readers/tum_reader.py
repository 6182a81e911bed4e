"""TUM RGB-D reader: a directory of depth PNGs as organized clouds.

Port of the reference package's ``scripts/readers/tum_reader.py``; the
default intrinsics are the TUM fr3 factory calibration the C++ reference's
reader hardcodes.
"""

from __future__ import annotations

import pathlib

import numpy as np

TUM_FR3_INTRINSICS = np.array(
    [[535.4, 0.0, 320.1], [0.0, 539.2, 247.6], [0.0, 0.0, 1.0]], dtype=np.float32)


class TumReader:
    def __init__(self, dataset_dir: str, intrinsics: np.ndarray | None = None):
        self.dir = pathlib.Path(dataset_dir)
        self.intrinsics = TUM_FR3_INTRINSICS if intrinsics is None else intrinsics
        self.frames = sorted(self.dir.glob("*.png"))

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self):
        from deplex_tpu_torch.utils import DepthImage

        image = DepthImage()
        for path in self.frames:
            image.reset(str(path))
            yield path.stem, image.transform_to_pcd(self.intrinsics)
