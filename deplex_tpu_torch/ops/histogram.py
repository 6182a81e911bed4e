"""Stage 2 — spherical normals histogram for seed selection.

Port of ``deplex_tpu.ops.histogram``: the reference's NormalsHistogram bin of
every cell, and the histogram of the live cells as a ``bincount``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deplex_tpu_torch.ops.eigh3x3 import f64_rounded


def normal_bins(normal: torch.Tensor, planar: torch.Tensor, nr_bins: int) -> torch.Tensor:
    """Bin index per cell (int32); -1 for non-planar cells.

    polar = acos(-nz) in [0, pi], azimuth = atan2(nx/rho, ny/rho) in
    [-pi, pi], each quantized to (nr_bins - 1) steps; the azimuth bin is
    forced to 0 when the polar bin is 0. Where rho == 0 the azimuth is 0.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    rho = f64_rounded(torch.sqrt, nx * nx + ny * ny)
    polar = f64_rounded(torch.acos, torch.clamp(-nz, -1.0, 1.0))
    has_rho = rho > 0
    safe_rho = torch.where(has_rho, rho, torch.ones_like(rho))
    azimuth = f64_rounded(torch.atan2, nx / safe_rho, ny / safe_rho)
    azimuth = torch.where(has_rho, azimuth, torch.zeros_like(azimuth))

    # The reference pipeline runs jitted, where XLA folds `(k * a) / c` into
    # `a * (k / c)` with k / c rounded once in float32; the same constants
    # here give the same bins at bin edges.
    polar_scale = float(np.float32(nr_bins - 1) / np.float32(math.pi))
    azimuth_scale = float(np.float32(nr_bins - 1) / np.float32(2 * math.pi))
    xq = (polar * polar_scale).to(torch.int32)
    yq = ((azimuth + math.pi) * azimuth_scale).to(torch.int32)
    yq = torch.where(xq > 0, yq, torch.zeros_like(yq))
    bins = yq * nr_bins + xq
    return torch.where(planar, bins, torch.full_like(bins, -1))


def histogram_counts(bins: torch.Tensor, nr_bins: int) -> torch.Tensor:
    """Histogram of one frame's live cells (0 <= bin < nr_bins^2) -> int32."""
    size = nr_bins * nr_bins
    flat = bins.reshape(-1)
    live = flat[(flat >= 0) & (flat < size)].to(torch.int64)
    return torch.bincount(live, minlength=size).to(torch.int32)
