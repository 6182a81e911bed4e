"""Stage 1 — cell-grid statistics (planarity estimation).

Port of ``deplex_tpu.ops.cellstats``. Every P x P cell of the frame is reduced
to its moments (``CellMoments``), then the PCA plane fit and the validity
gates run on the (B, gh, gw) planes (``finalize_cell_stats``). All tensors
carry a leading frame axis B.

The pixel-level reduction is the hand kernel ``csrc/cellstats.cu`` on the
card; ``cell_moments_reference`` below is its plain twin (and what runs on
the CPU). Both keep the reference package's formulas:
  * cell sums count ALL P*P pixels, invalid (z == 0) ones included;
  * second moments are taken about the cell's first pixel (anchoring) with
    the mean-centering folded in, ``sum(a*b) - Sa*Sb/n``; on grids where
    the reference has no band plan the plain centered form is used instead;
  * the depth-continuity walks follow linear in-cell indices, so for odd P
    the mid-row walk wraps into the next row;
  * negative diagonal moments from the fold are kept, not clamped.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.eigh3x3 import eigh3x3_min, f64_rounded

F32_MAX = torch.finfo(torch.float32).max


class CellStats(NamedTuple):
    """Per-cell quantities, all shaped (B, gh, gw, ...)."""

    planar: torch.Tensor      # (B, gh, gw) bool
    normal: torch.Tensor      # (B, gh, gw, 3) unit normal, oriented so d >= 0
    mean: torch.Tensor        # (B, gh, gw, 3) mean over all P*P points
    d: torch.Tensor           # (B, gh, gw) plane offset, >= 0
    mse: torch.Tensor         # (B, gh, gw) lambda_min / n (F32_MAX if not planar)
    tol: torch.Tensor         # (B, gh, gw) squared merge tolerance
    nr_pts: torch.Tensor      # () points per cell (P*P), float32
    coord_sum: torch.Tensor   # (B, gh, gw, 3) sum of points
    scatter: torch.Tensor     # (B, gh, gw, 3, 3) centered second moments


class CellMoments(NamedTuple):
    """Raw per-cell moments: the output of the stage-1 kernel."""

    nr_valid: torch.Tensor    # (B, gh, gw) count of z > 0 points (float32)
    disc_h: torch.Tensor      # (B, gh, gw) mid-row depth discontinuities
    disc_v: torch.Tensor      # (B, gh, gw) mid-column depth discontinuities
    coord_sum: torch.Tensor   # (B, gh, gw, 3) sum of points (zeros included)
    scatter: torch.Tensor     # (B, gh, gw, 3, 3) centered second moments
    diam: torch.Tensor        # (B, gh, gw) first-to-last pixel distance


def patch_size(image_height: int, image_width: int, config: Config) -> int:
    """The effective cell side: the configured patch, capped by the frame."""
    return min(config.patch_size, min(image_height, image_width))


def moments_band_plan_exists(gh: int, patch: int, cell_width: int) -> bool:
    """Whether the reference package tiles this grid with its banded,
    anchored moment reduction (``cellstats.moments_band_plan`` there).

    On the GPU there are no bands; this test only selects the formula
    (anchored + folded where a plan exists, plainly centered where not),
    so that both packages compute the same thing on every grid.
    """
    for gh_pad in range(gh, gh + 65):
        hc = gh_pad * patch
        for s in range(1, gh_pad + 1):
            if gh_pad % s == 0 and (gh_pad // s) % 8 == 0 and \
                    6 * (hc // s) * cell_width * 4 <= 6 * 1024 * 1024:
                return True
    return False


def finalize_cell_stats(m: CellMoments, P: int, config: Config) -> CellStats:
    """PCA eigensolve and all validity gates on the (B, gh, gw) planes."""
    n = torch.full((), float(P * P), dtype=torch.float32, device=m.diam.device)
    valid_thr = (P * P * 3) // config.min_pts_per_cell
    has_valid = m.nr_valid >= valid_thr
    max_disc = config.max_number_depth_discontinuity
    continuous = (m.disc_h < max_disc) & (m.disc_v < max_disc)

    mean = m.coord_sum / n
    w, v = eigh3x3_min(m.scatter)
    d_raw = -(mean[..., 0] * v[..., 0] + mean[..., 1] * v[..., 1]
              + mean[..., 2] * v[..., 2])
    normal = torch.where((d_raw > 0)[..., None], v, -v)
    d = torch.abs(d_raw)
    mse = w[..., 0] / n

    sigma = config.depth_sigma_coeff * mean[..., 2] ** 2 + config.depth_sigma_margin
    small_error = mse <= sigma * sigma
    planar = has_valid & continuous & small_error

    sin_angle = math.sqrt(max(0.0, 1.0 - min(config.min_cos_angle_merge, 1.0) ** 2))
    tol = torch.clamp(m.diam * sin_angle, 20.0, config.max_merge_dist) ** 2

    # Non-planar cells carry the largest float MSE so they never seed.
    mse = torch.where(planar, mse, torch.full_like(mse, F32_MAX))
    return CellStats(planar=planar, normal=normal, mean=mean, d=d, mse=mse,
                     tol=tol, nr_pts=n, coord_sum=m.coord_sum, scatter=m.scatter)


def _symmetric(xx, xy, xz, yy, yz, zz) -> torch.Tensor:
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def moments_from_planes(planes: torch.Tensor) -> CellMoments:
    """(13, B, gh, gw) planes in kernel order -> CellMoments.

    Order: count, disc_h, disc_v, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz,
    diam.
    """
    (cnt, dh, dv, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz, diam) = planes.unbind(0)
    return CellMoments(nr_valid=cnt, disc_h=dh, disc_v=dv,
                       coord_sum=torch.stack([sx, sy, sz], -1),
                       scatter=_symmetric(sxx, sxy, sxz, syy, syz, szz), diam=diam)


def planes_from_moments(m: CellMoments) -> torch.Tensor:
    """CellMoments -> (13, B, gh, gw) planes in kernel order (the inverse of
    ``moments_from_planes``)."""
    sc, cs = m.scatter, m.coord_sum
    return torch.stack([m.nr_valid, m.disc_h, m.disc_v, cs[..., 0], cs[..., 1], cs[..., 2],
                        sc[..., 0, 0], sc[..., 0, 1], sc[..., 0, 2], sc[..., 1, 1],
                        sc[..., 1, 2], sc[..., 2, 2], m.diam])


def camera_params(K: torch.Tensor) -> torch.Tensor:
    """3x3 intrinsics -> (4,) float32 (fx, fy, cx, cy) on K's device: what K1
    reads from device memory, and what the back-projection divides by."""
    K = K.to(torch.float32).reshape(3, 3)
    return torch.stack((K[0, 0], K[1, 1], K[0, 2], K[1, 2]))


def _xyz_images(src: torch.Tensor, K: torch.Tensor | None, Hc: int, Wc: int):
    """(B, H, W) depth + K, or (B, H, W, 3) points -> cropped x, y, z images."""
    if src.dim() == 4:
        pts = src[:, :Hc, :Wc, :].to(torch.float32)
        return tuple(pts[..., k].contiguous() for k in range(3))
    fx, fy, cx, cy = camera_params(K.to(src.device)).unbind()
    if src.dtype == torch.uint16:   # few ops take uint16: widen its bytes
        src = src.view(torch.int16).to(torch.int32) & 0xFFFF
    z = src[:, :Hc, :Wc].to(torch.float32)
    u = (torch.arange(Wc, dtype=torch.float32, device=src.device)[None, :] - cx) / fx
    v = (torch.arange(Hc, dtype=torch.float32, device=src.device)[:, None] - cy) / fy
    return u * z, v * z, z


def cell_moments_reference(src: torch.Tensor, K: torch.Tensor | None,
                           config: Config) -> CellMoments:
    """Plain twin of the stage-1 kernel.

    src: (B, H, W) depth (any integer or float dtype) with K the 3x3
    intrinsics, or a (B, H, W, 3) organized cloud with K None. Each cell's
    sums are taken in the kernel's order: down each in-cell column, then
    across the column sums (as the reference's row-then-column segment
    matmuls do), so on the same input the two round alike.
    """
    B, H, W = src.shape[:3]
    P = patch_size(H, W, config)
    gh, gw = H // P, W // P
    x, y, z = _xyz_images(src, K, gh * P, gw * P)
    # A device tensor, not a Python number: on the card torch divides by a
    # host scalar as a multiply by its reciprocal, the kernel truly divides.
    n = torch.full((), float(P * P), dtype=torch.float32, device=z.device)

    def blocks(a):
        """(B, gh*P, gw*P) -> (B, gh, gw) per-cell sums, added in order."""
        rows = a.reshape(B, gh, P, gw, P)
        col = torch.zeros((B, gh, gw, P), dtype=a.dtype, device=a.device)
        for i in range(P):
            col = col + rows[:, :, i]
        acc = torch.zeros((B, gh, gw), dtype=a.dtype, device=a.device)
        for j in range(P):
            acc = acc + col[..., j]
        return acc

    nr_valid = blocks((z > 0).to(torch.float32))

    thr = config.depth_discontinuity_threshold

    def walk(in_cell_indices):
        """Carried-prev walk over linear in-cell indices; counts jumps."""
        def cell_slice(i):
            return z[:, i // P::P, i % P::P]
        prev = cell_slice(in_cell_indices[0])
        disc = torch.zeros_like(prev)
        for i in in_cell_indices:
            curr = cell_slice(i)
            pos = curr > 0
            cont = pos & (torch.abs(curr - prev) < thr)
            prev = torch.where(cont, curr, prev)
            disc = disc + (pos & ~cont).to(torch.float32)
        return disc

    mid = P * P // 2
    disc_h = walk([mid + t for t in range(P)])
    disc_v = walk([P // 2 + t * P for t in range(P)])

    sx, sy, sz = blocks(x), blocks(y), blocks(z)

    def per_pixel(m):
        """(B, gh, gw) per-cell value -> (B, gh*P, gw*P) over its pixels."""
        return m[:, :, None, :, None].expand(B, gh, P, gw, P).reshape(B, gh * P, gw * P)

    if moments_band_plan_exists(gh, P, gw * P):
        # Anchor at each cell's first pixel, fold the centering.
        xs = x - per_pixel(x[:, ::P, ::P])
        ys = y - per_pixel(y[:, ::P, ::P])
        zs = z - per_pixel(z[:, ::P, ::P])
        sxs, sys_, szs = blocks(xs), blocks(ys), blocks(zs)
        scatter = _symmetric(blocks(xs * xs) - sxs * (sxs / n),
                             blocks(xs * ys) - sxs * (sys_ / n),
                             blocks(xs * zs) - sxs * (szs / n),
                             blocks(ys * ys) - sys_ * (sys_ / n),
                             blocks(ys * zs) - sys_ * (szs / n),
                             blocks(zs * zs) - szs * (szs / n))
    else:
        cx_ = x - per_pixel(sx / n)
        cy_ = y - per_pixel(sy / n)
        cz_ = z - per_pixel(sz / n)
        scatter = _symmetric(blocks(cx_ * cx_), blocks(cx_ * cy_), blocks(cx_ * cz_),
                             blocks(cy_ * cy_), blocks(cy_ * cz_), blocks(cz_ * cz_))

    dx = x[:, ::P, ::P] - x[:, P - 1::P, P - 1::P]
    dy = y[:, ::P, ::P] - y[:, P - 1::P, P - 1::P]
    dz = z[:, ::P, ::P] - z[:, P - 1::P, P - 1::P]
    diam = f64_rounded(torch.sqrt, dx * dx + dy * dy + dz * dz)

    return CellMoments(nr_valid=nr_valid, disc_h=disc_h, disc_v=disc_v,
                       coord_sum=torch.stack([sx, sy, sz], -1), scatter=scatter,
                       diam=diam)
