"""Intrinsics file I/O (numpy only), with the error string of
``deplex_tpu.utils.io.read_intrinsics`` (the reference's readIntrinsics)."""

from __future__ import annotations

import numpy as np


def read_intrinsics(path: str) -> np.ndarray:
    """Read a whitespace-separated 3x3 intrinsics matrix."""
    try:
        vals = np.loadtxt(path, dtype=np.float32)
    except OSError as e:
        raise RuntimeError(f"Error: Couldn't open intrinsics file {path}") from e
    return np.asarray(vals, dtype=np.float32).reshape(3, 3)
