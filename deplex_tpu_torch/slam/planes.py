"""Plane-landmark parameterizations and frame transforms.

Port of ``deplex_tpu.slam.planes``. A plane is (n, d) with n . x + d = 0,
|n| = 1, d >= 0 (the extractor's convention), or its closest-point vector
eta = -d n (the bundle adjustment's 3-parameter form).

Transform convention: T_cw = (R, t) maps world points into the camera,
x_c = R x_w + t; for planes n_c = R n_w, d_c = d_w - n_c . t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deplex_tpu_torch.slam.lie import _matvec


class PlaneObs(NamedTuple):
    """Fixed-capacity per-frame plane observations (camera frame)."""

    normal: torch.Tensor   # (MAXP, 3) unit normals
    d: torch.Tensor        # (MAXP,) offsets (n.x + d = 0)
    weight: torch.Tensor   # (MAXP,) point-count weights; 0 = empty slot
    mean: torch.Tensor     # (MAXP, 3) centroids (for association gating)


def from_segments(segments) -> PlaneObs:
    """One frame's PlaneSegments (ops.growing, no frame axis) -> PlaneObs;
    empty slots get weight 0."""
    occupied = torch.arange(segments.n.shape[-1], device=segments.n.device) < segments.nr_planes
    w = torch.where(occupied, segments.n, torch.zeros_like(segments.n))
    return PlaneObs(normal=segments.normal, d=segments.d, weight=w, mean=segments.mean)


def to_cp(normal: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(n, d) -> closest-point vector eta = -d n."""
    return -d[..., None] * normal


def from_cp(eta: torch.Tensor):
    """eta -> (n, d) with d = |eta| >= 0, n = -eta / |eta|; eta ~ 0 (a plane
    through the origin) gets n = +z, and callers keep it masked out."""
    d = torch.linalg.vector_norm(eta, dim=-1)
    safe = d > 1e-12
    n = torch.where(safe[..., None],
                    -eta / torch.where(safe, d, torch.ones_like(d))[..., None],
                    torch.eye(3, dtype=eta.dtype, device=eta.device)[2])
    return n, d


def transform_plane(R: torch.Tensor, t: torch.Tensor, n_w: torch.Tensor, d_w: torch.Tensor):
    """World plane -> camera plane under x_c = R x_w + t (batched)."""
    n_c = _matvec(R, n_w)
    d_c = d_w - torch.sum(n_c * t, dim=-1)
    return n_c, d_c


def untransform_plane(R: torch.Tensor, t: torch.Tensor, n_c: torch.Tensor, d_c: torch.Tensor):
    """Camera plane -> world plane (inverse of transform_plane)."""
    n_w = _matvec(R.transpose(-1, -2), n_c)
    d_w = d_c + torch.sum(n_c * t, dim=-1)
    return n_w, d_w
