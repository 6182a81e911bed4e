"""User-facing PlaneExtractor — API parity with the reference binding.

Construct with (image_height, image_width, config=Config()); call
``process(points[N, 3]) -> labels[N]`` with 0 = non-planar, or
``process_depth(depth, K)``. ``device`` picks where the pipeline runs: the
card (hand kernels) by default, or ``device="cpu"`` for the plain twins.
Without a card and without ``device`` the constructor raises.
"""

from __future__ import annotations

import numpy as np
import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.pipeline import (check_patch, depth_tensor, extract_planes,
                                       extract_planes_from_depth, resolve_device)


class PlaneExtractor:
    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None, device=None):
        config = config if config is not None else Config()
        check_patch(image_height, image_width, config)
        self._height = int(image_height)
        self._width = int(image_width)
        self._config = config
        self._device = resolve_device(device)

    @property
    def config(self) -> Config:
        return self._config

    @property
    def image_height(self) -> int:
        return self._height

    @property
    def image_width(self) -> int:
        return self._width

    @property
    def device(self) -> torch.device:
        return self._device

    def process(self, pcd_array) -> np.ndarray:
        """Organized (H*W, 3) point cloud -> (H*W,) int32 labels, 0 = none."""
        pts = np.asarray(pcd_array, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] != self._height * self._width:
            rows = 0 if pts.ndim < 2 else pts.shape[0]
            raise ValueError(
                f"Error! Number of points doesn't match image shape: {rows}"
                f" != {self._height} x {self._width}")
        labels = extract_planes(torch.from_numpy(pts).to(self._device),
                                image_height=self._height, image_width=self._width,
                                config=self._config)
        return labels.cpu().numpy()

    def process_depth(self, depth, intrinsics) -> np.ndarray:
        """(H, W) uint16 depth map + 3x3 intrinsics -> (H*W,) int32 labels."""
        d = np.asarray(depth)
        if d.shape != (self._height, self._width):
            raise ValueError(
                f"Error! Depth shape {d.shape} != ({self._height}, {self._width})")
        labels = extract_planes_from_depth(depth_tensor(d, self._device), intrinsics,
                                           config=self._config)
        return labels.cpu().numpy()
