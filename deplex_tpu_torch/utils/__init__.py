"""I/O utilities (numpy only): depth PNGs, intrinsics, CSV clouds and labels."""

from deplex_tpu_torch.utils.depth_image import DepthImage
from deplex_tpu_torch.utils.io import read_intrinsics, read_pcd_csv, save_labels_csv, save_pcd_csv

__all__ = ["DepthImage", "read_intrinsics", "read_pcd_csv", "save_labels_csv", "save_pcd_csv"]
