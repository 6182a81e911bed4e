"""Cylinder extraction: CAPE's second primitive, from the growing rounds.

Port of ``deplex_tpu.ops.cylinder``. Candidates are growing rounds that
passed the size gate but fit a plane badly (low planarity score, or a plane
MSE above the depth-adaptive sensor band): smooth but curved surfaces. For
every round at once:
  * axis = the eigenvector of the smallest eigenvalue of the round's normal
    covariance (a cylinder's normals span the disc orthogonal to its axis);
  * the member cell centroids, projected onto the plane orthogonal to the
    axis and centered per round, get a Kasa algebraic circle fit (one 3x3
    solve per round, written out in closed form);
  * a round is a cylinder when its radial RMSE is under a radius-relative
    tolerance and below the plane fit's RMSE.
Accepted rounds get cylinder ids 1..C in a label map of their own. All
tensors carry a leading frame axis B.

Numerics: the reductions over cells are sums and matrix products of one-hot
weights (no float atomics decide a gate), the 3x3 solve is Cramer's rule in
float32 (the same rounding on the card and the CPU, where the reference's
LU solve would round per library), and square roots go through
``f64_rounded``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.cellstats import CellStats
from deplex_tpu_torch.ops.eigh3x3 import eigh3x3_min, f64_rounded
from deplex_tpu_torch.ops.growing import _N, _SIZE, _SX, _XX, RoundData, fit_plane


class CylinderSegments(NamedTuple):
    """Fixed-capacity (max_cylinders) cylinder slots per frame; slot 0 =
    cylinder 1. Unfilled slots are zero."""

    nr_cylinders: torch.Tensor   # (B,) int32
    axis: torch.Tensor           # (B, MAXC, 3) unit axis direction
    center: torch.Tensor         # (B, MAXC, 3) a point on the axis
    radius: torch.Tensor         # (B, MAXC)
    rmse: torch.Tensor           # (B, MAXC) radial RMSE
    size: torch.Tensor           # (B, MAXC) member cell count


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def solve3_symmetric(a, b, c, d, e, f, r0, r1, r2):
    """Solve [[a, b, c], [b, d, e], [c, e, f]] x = [r0, r1, r2] by Cramer's
    rule, elementwise over same-shape float32 tensors. Returns (x0, x1, x2);
    a singular system gives inf or nan."""
    m00 = d * f - e * e
    m01 = c * e - b * f
    m02 = b * e - c * d
    det = a * m00 + b * m01 + c * m02
    x0 = (m00 * r0 + m01 * r1 + m02 * r2) / det
    x1 = (m01 * r0 + (a * f - c * c) * r1 + (b * c - a * e) * r2) / det
    x2 = (m02 * r0 + (b * c - a * e) * r1 + (a * d - b * b) * r2) / det
    return x0, x1, x2


def extract_cylinders(stats: CellStats, rounds: RoundData, config: Config):
    """Fit cylinders to the plane-rejected rounds of (B, gh, gw) frames.

    Returns (cyl_labels_map (B, gh, gw) int32, CylinderSegments); label 0 =
    no cylinder."""
    B, gh, gw = stats.planar.shape
    N = gh * gw
    sums = rounds.sums
    R_MAX = sums.shape[1]
    MAXC = config.max_cylinders
    dev = sums.device
    f32 = torch.float32

    # The plane gates again, to find the candidates.
    n = torch.clamp(sums[..., _N], min=1.0)
    sc = sums[..., _XX:_XX + 6]
    scatter = torch.stack([
        torch.stack([sc[..., 0], sc[..., 1], sc[..., 2]], -1),
        torch.stack([sc[..., 1], sc[..., 3], sc[..., 4]], -1),
        torch.stack([sc[..., 2], sc[..., 4], sc[..., 5]], -1),
    ], -2)
    size = sums[..., _SIZE]
    _, mean_r, _, mse_r, score = fit_plane(scatter, sums[..., _SX:_SX + 3], n)
    live = torch.arange(R_MAX, device=dev)[None, :] < rounds.nr_rounds[:, None]
    # CAPE's candidate rule: a poor plane, by planarity score or by plane MSE
    # over the depth-adaptive sensor band.
    sigma = config.depth_sigma_coeff * mean_r[..., 2] ** 2 + config.depth_sigma_margin
    bad_plane = (score <= config.min_region_planarity_score) | (mse_r > sigma * sigma)
    candidate = live & (size >= config.min_cylinder_cells) & bad_plane

    # Per-round one-hot over cells: (B, R_MAX, N).
    rm = rounds.round_map.reshape(B, N)
    w = (rm[:, None, :] == torch.arange(R_MAX, dtype=rm.dtype, device=dev)[None, :, None]
         ).to(f32)
    normals = stats.normal.reshape(B, N, 3).to(f32)
    means = stats.mean.reshape(B, N, 3).to(f32)

    # Axis: smallest-eigenvalue direction of the normal covariance.
    nn = (normals[..., :, None] * normals[..., None, :]).reshape(B, N, 9)
    _, axis = eigh3x3_min(torch.bmm(w, nn).reshape(B, R_MAX, 3, 3))

    # Orthonormal basis (u, v) of the plane orthogonal to the axis.
    # Unit vectors made on the device (a host copy cannot be recorded in a
    # CUDA graph).
    ex, ey = torch.eye(3, device=dev)[:2]
    u = _cross(axis, torch.where(torch.abs(axis[..., :1]) < 0.9, ex, ey))
    u_norm = f64_rounded(torch.sqrt, (u * u).sum(-1, keepdim=True))
    u = u / torch.clamp(u_norm, min=1e-12)
    v = _cross(axis, u)

    # Member centroids in (u, v), centered per round: raw projections are
    # O(1e3) mm, and uncentered moments of 1e12 lose the circle in float32.
    px = torch.bmm(u, means.transpose(1, 2))                         # (B, R, N)
    py = torch.bmm(v, means.transpose(1, 2))
    cnt = torch.clamp(w.sum(-1), min=1.0)
    mx_c = (w * px).sum(-1) / cnt
    my_c = (w * py).sum(-1) / cnt
    px = (px - mx_c[..., None]) * w
    py = (py - my_c[..., None]) * w
    bsq = px * px + py * py

    # Kasa normal equations for [2 cx, 2 cy, r^2 - |c|^2], design [x, y, 1].
    Sxx, Sxy, Syy = (w * px * px).sum(-1), (w * px * py).sum(-1), (w * py * py).sum(-1)
    Sx, Sy, Sb = (w * px).sum(-1), (w * py).sum(-1), (w * bsq).sum(-1)
    Sxb, Syb = (w * px * bsq).sum(-1), (w * py * bsq).sum(-1)
    ridge = 1e-6 * torch.clamp(Sxx + Syy + cnt, min=1.0) / torch.full((), 3.0, device=dev)
    s0, s1, s2 = solve3_symmetric(Sxx + ridge, Sxy, Sx, Syy + ridge, Sy, cnt + ridge,
                                  Sxb, Syb, Sb)
    cx, cy = s0 * 0.5, s1 * 0.5
    radius = f64_rounded(torch.sqrt, torch.clamp(s2 + cx * cx + cy * cy, min=0.0))

    # Radial residual.
    dist = f64_rounded(torch.sqrt, torch.clamp((px - cx[..., None]) ** 2
                                               + (py - cy[..., None]) ** 2, min=1e-12))
    res = (dist - radius[..., None]) ** 2
    rmse = f64_rounded(torch.sqrt, (w * res).sum(-1) / cnt)

    ok = (candidate & torch.isfinite(radius) & (radius > 0)
          & (rmse <= torch.clamp(config.cylinder_rmse_rel * radius,
                                 min=config.cylinder_rmse_max))
          # The cylinder must explain the region better than the plane did.
          & (rmse * rmse < mse_r))
    slot = torch.cumsum(ok.to(torch.int32), dim=1) - 1
    ok = ok & (slot < MAXC)
    nr = ok.sum(1).to(torch.int32)

    # A point on the axis: the projected center, the centering undone.
    center3d = (cx + mx_c)[..., None] * u + (cy + my_c)[..., None] * v

    label_of_round = torch.where(ok, slot + 1, torch.zeros_like(slot)).to(torch.int32)
    lut = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev), label_of_round], 1)
    cyl_labels_map = torch.gather(lut, 1, rm.to(torch.int64) + 1).reshape(B, gh, gw)

    # Slot tables: the round that filled each slot (each slot has at most one).
    round_of_slot = torch.zeros((B, MAXC + 1), dtype=torch.int64, device=dev)
    target = torch.where(ok, slot, torch.full_like(slot, MAXC)).to(torch.int64)
    round_of_slot.scatter_(1, target, torch.arange(R_MAX, device=dev).expand(B, R_MAX).contiguous())
    idx = round_of_slot[:, :MAXC]
    filled = torch.arange(MAXC, device=dev)[None, :] < nr[:, None]

    def table(x):
        """(B, R, ...) per-round values -> (B, MAXC, ...) slot values."""
        tail = (1,) * (x.dim() - 2)
        g = torch.gather(x, 1, idx.reshape(B, MAXC, *tail).expand(B, MAXC, *x.shape[2:]))
        return torch.where(filled.reshape(B, MAXC, *tail), g, torch.zeros_like(g))

    seg = CylinderSegments(nr_cylinders=nr, axis=table(axis), center=table(center3d),
                           radius=table(radius), rmse=table(rmse), size=table(size))
    return cyl_labels_map, seg
