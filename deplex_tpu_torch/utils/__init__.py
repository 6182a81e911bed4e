"""I/O utilities (numpy only): depth PNGs and intrinsics."""

from deplex_tpu_torch.utils.depth_image import DepthImage
from deplex_tpu_torch.utils.io import read_intrinsics

__all__ = ["DepthImage", "read_intrinsics"]
