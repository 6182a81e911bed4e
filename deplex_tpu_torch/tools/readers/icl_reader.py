"""ICL-NUIM reader: a directory of depth PNGs as organized clouds.

Port of the reference package's ``scripts/readers/icl_reader.py``; the
default intrinsics are the living-room calibration the C++ reference's
reader hardcodes (fy negative: ICL-NUIM's image y axis points up).
"""

from __future__ import annotations

import pathlib

import numpy as np

ICL_INTRINSICS = np.array(
    [[481.2, 0.0, 319.5], [0.0, -480.0, 239.5], [0.0, 0.0, 1.0]], dtype=np.float32)


class IclReader:
    def __init__(self, dataset_dir: str, intrinsics: np.ndarray | None = None):
        self.dir = pathlib.Path(dataset_dir)
        self.intrinsics = ICL_INTRINSICS if intrinsics is None else intrinsics
        self.frames = sorted(self.dir.glob("*.png"), key=lambda p: p.stem)

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self):
        from deplex_tpu_torch.utils import DepthImage

        image = DepthImage()
        for path in self.frames:
            image.reset(str(path))
            yield path.stem, image.transform_to_pcd(self.intrinsics)
