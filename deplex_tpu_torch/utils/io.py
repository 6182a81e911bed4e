"""Point-cloud, label and intrinsics file I/O (numpy only).

Port of ``deplex_tpu.utils.io``, the reference's CSV protocol: the same
readers, the same error strings, and writers whose files are byte-equal to
the reference package's.
"""

from __future__ import annotations

import numpy as np


def read_pcd_csv(path: str, delimiter: str = ",") -> np.ndarray:
    """Read an (N, 3) float32 point cloud from CSV."""
    flat = np.loadtxt(path, delimiter=delimiter, dtype=np.float32).reshape(-1)
    if flat.size % 3 != 0:
        raise RuntimeError("Error reading file: Invalid points shape")
    return flat.reshape(-1, 3)


def read_intrinsics(path: str) -> np.ndarray:
    """Read a whitespace-separated 3x3 intrinsics matrix."""
    try:
        vals = np.loadtxt(path, dtype=np.float32)
    except OSError as e:
        raise RuntimeError(f"Error: Couldn't open intrinsics file {path}") from e
    return np.asarray(vals, dtype=np.float32).reshape(3, 3)


def save_pcd_csv(points: np.ndarray, path: str) -> None:
    """Write an (N, M) array as CSV: comma-separated, one row a line, %g."""
    np.savetxt(path, np.asarray(points), delimiter=",", fmt="%g")


def save_labels_csv(labels: np.ndarray, path: str) -> None:
    """One integer label a line (the reference's label dumps)."""
    np.savetxt(path, np.asarray(labels).reshape(-1), fmt="%d")
