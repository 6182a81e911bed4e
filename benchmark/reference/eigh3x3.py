"""Batched closed-form symmetric 3x3 eigensolve (smallest eigenpair).

Port of ``deplex_tpu.ops.eigh3x3``: Cardano's analytic eigenvalues (the
reference's dsyevc3 formulation) and the eigenvector of the smallest one as
the best-conditioned of the three column cross products of A - lambda*I.
Matrices are scaled by their largest |entry| first. ``csrc/common.cuh`` holds
the same arithmetic for one matrix on the card. ``eigvals3x3_sym`` and
``eigh3x3`` (all three eigenvectors, numpy's column convention) are the
reference package's public helpers; ``eigh3x3_min_np`` is its numpy twin.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def f64_rounded(fn, *args: torch.Tensor) -> torch.Tensor:
    """fn evaluated in float64 and rounded to float32.

    The float32 atan2, cos, sin and acos of the card and of the CPU (and the
    CPU's float32 sqrt) differ in the last bit on a fair share of inputs; on
    cells whose lambda_min is rounding noise that moves normals by ~1e-4 and
    reorders the growing rounds. Through float64 both devices round to the
    same float32 (so does csrc/common.cuh), so the CPU twins give the card's
    bits."""
    return fn(*(a.to(torch.float64) for a in args)).to(torch.float32)


def _eigvals_soa(a, b, c, d, e, f):
    """Ascending Cardano eigenvalues from the 6 distinct entries
    (a, b, c on the diagonal; d = xy, e = yz, f = xz)."""
    de = d * e
    dd = d * d
    ee = e * e
    ff = f * f
    m = a + b + c
    c1 = (a * b + a * c + b * c) - (dd + ee + ff)
    c0 = c * dd + a * ee + b * ff - a * b * c - 2.0 * f * de

    p = m * m - 3.0 * c1
    q = m * (p - 1.5 * c1) - 13.5 * c0
    sqrt_p = f64_rounded(torch.sqrt, torch.abs(p))

    phi = 27.0 * (0.25 * c1 * c1 * (p - c1) + c0 * (q + 6.75 * c0))
    phi = (1.0 / 3.0) * f64_rounded(torch.atan2, f64_rounded(torch.sqrt, torch.abs(phi)), q)

    cphi = sqrt_p * f64_rounded(torch.cos, phi)
    sphi = (1.0 / math.sqrt(3.0)) * sqrt_p * f64_rounded(torch.sin, phi)

    wc = (1.0 / 3.0) * (m - cphi)
    w0 = wc + cphi
    w1 = wc - sphi
    w2 = wc + sphi

    lo = torch.minimum(torch.minimum(w0, w1), w2)
    hi = torch.maximum(torch.maximum(w0, w1), w2)
    # Median by a min/max network: always one of the three roots exactly.
    mid = torch.maximum(torch.minimum(w0, w1),
                        torch.minimum(torch.maximum(w0, w1), w2))
    return lo, mid, hi


def _cross_soa(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _eigvec_min_soa(a, b, c, d, e, f, lam):
    """Unit eigenvector for eigenvalue lam: the largest-norm cross product of
    the column pairs (01, 12, 20) of A - lam*I; e_z for isotropic input."""
    c0x, c0y, c0z = a - lam, d, f
    c1x, c1y, c1z = d, b - lam, e
    c2x, c2y, c2z = f, e, c - lam
    v01 = _cross_soa(c0x, c0y, c0z, c1x, c1y, c1z)
    v12 = _cross_soa(c1x, c1y, c1z, c2x, c2y, c2z)
    v20 = _cross_soa(c2x, c2y, c2z, c0x, c0y, c0z)
    n01 = v01[0] * v01[0] + v01[1] * v01[1] + v01[2] * v01[2]
    n12 = v12[0] * v12[0] + v12[1] * v12[1] + v12[2] * v12[2]
    n20 = v20[0] * v20[0] + v20[1] * v20[1] + v20[2] * v20[2]
    use12 = n12 > torch.maximum(n01, n20)
    use01 = (~use12) & (n01 >= n20)
    vx = torch.where(use12, v12[0], torch.where(use01, v01[0], v20[0]))
    vy = torch.where(use12, v12[1], torch.where(use01, v01[1], v20[1]))
    vz = torch.where(use12, v12[2], torch.where(use01, v01[2], v20[2]))
    nrm = f64_rounded(torch.sqrt, vx * vx + vy * vy + vz * vz)
    safe = nrm > 0
    inv = 1.0 / torch.where(safe, nrm, torch.ones_like(nrm))
    zero = torch.zeros_like(nrm)
    return (torch.where(safe, vx * inv, zero),
            torch.where(safe, vy * inv, zero),
            torch.where(safe, vz * inv, torch.ones_like(nrm)))


def eigh3x3_min_soa(xx, xy, xz, yy, yz, zz):
    """Smallest eigenpair from the 6 distinct entries (same-shape tensors).

    Returns ((w0, w1, w2), (vx, vy, vz)): ascending eigenvalues and the unit
    eigenvector of w0.
    """
    scale = torch.maximum(
        torch.maximum(torch.maximum(torch.abs(xx), torch.abs(yy)),
                      torch.maximum(torch.abs(zz), torch.abs(xy))),
        torch.maximum(torch.abs(yz), torch.abs(xz)))
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    inv = 1.0 / scale
    a, b, c = xx * inv, yy * inv, zz * inv
    d, e, f = xy * inv, yz * inv, xz * inv
    w0, w1, w2 = _eigvals_soa(a, b, c, d, e, f)
    v = _eigvec_min_soa(a, b, c, d, e, f, w0)
    return (w0 * scale, w1 * scale, w2 * scale), v


def eigh3x3_min(A: torch.Tensor):
    """(..., 3, 3) symmetric -> (w (..., 3) ascending, v_min (..., 3))."""
    (w0, w1, w2), (vx, vy, vz) = eigh3x3_min_soa(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])
    return torch.stack([w0, w1, w2], dim=-1), torch.stack([vx, vy, vz], dim=-1)


def eigvals3x3_sym(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 3) Cardano eigenvalues, ascending (no
    scaling)."""
    lo, mid, hi = _eigvals_soa(A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
                               A[..., 0, 1], A[..., 1, 2], A[..., 0, 2])
    return torch.stack([lo, mid, hi], dim=-1)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit eigenvector of symmetric A for its eigenvalue lam."""
    vx, vy, vz = _eigvec_min_soa(A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
                                 A[..., 0, 1], A[..., 1, 2], A[..., 0, 2], lam)
    return torch.stack([vx, vy, vz], dim=-1)


def eigh3x3(A: torch.Tensor):
    """Full decomposition of (..., 3, 3) symmetric matrices: (w (..., 3)
    ascending, V (..., 3, 3)) with V[..., :, k] the eigenvector of w[..., k]
    (numpy.linalg.eigh's column convention). The matrices are scaled by
    their largest |entry|; the middle eigenvector is the cross product of
    the outer two."""
    scale = torch.amax(torch.abs(A), dim=(-2, -1), keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    As = A / scale
    w = eigvals3x3_sym(As)
    v0 = _eigvec_for(As, w[..., 0])
    v2 = _eigvec_for(As, w[..., 2])
    v1 = torch.stack(_cross_soa(*v2.unbind(-1), *v0.unbind(-1)), dim=-1)
    return w * scale[..., 0], torch.stack([v0, v1, v2], dim=-1)


def eigh3x3_min_np(A: np.ndarray):
    """numpy float64 twin of ``eigh3x3_min`` (the serial oracle's solver):
    (..., 3, 3) symmetric -> (w (..., 3) ascending, v_min (..., 3)), with
    numpy's sort and argmax in place of the min/max network."""
    A = np.asarray(A)
    scale = np.max(np.abs(A), axis=(-2, -1), keepdims=True)
    scale = np.where(scale > 0, scale, 1.0)
    As = A / scale
    a, b, c = As[..., 0, 0], As[..., 1, 1], As[..., 2, 2]
    d, e, f = As[..., 0, 1], As[..., 1, 2], As[..., 0, 2]
    de, dd, ee, ff = d * e, d * d, e * e, f * f
    m = a + b + c
    c1 = (a * b + a * c + b * c) - (dd + ee + ff)
    c0 = c * dd + a * ee + b * ff - a * b * c - 2.0 * f * de
    p = m * m - 3.0 * c1
    q = m * (p - 1.5 * c1) - 13.5 * c0
    sqrt_p = np.sqrt(np.abs(p))
    phi = 27.0 * (0.25 * c1 * c1 * (p - c1) + c0 * (q + 6.75 * c0))
    phi = (1.0 / 3.0) * np.arctan2(np.sqrt(np.abs(phi)), q)
    cphi = sqrt_p * np.cos(phi)
    sphi = (1.0 / np.sqrt(3.0)) * sqrt_p * np.sin(phi)
    wc = (1.0 / 3.0) * (m - cphi)
    w = np.sort(np.stack([wc + cphi, wc - sphi, wc + sphi], axis=-1), axis=-1)

    M = As - w[..., 0, None, None] * np.eye(3, dtype=As.dtype)
    col0, col1, col2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    cands = np.stack([np.cross(col0, col1), np.cross(col1, col2), np.cross(col2, col0)],
                     axis=-2)
    best = np.argmax(np.sum(cands * cands, axis=-1), axis=-1)
    v = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    nrm = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
    safe = nrm > 0
    v = np.where(safe, v / np.where(safe, nrm, 1.0), np.array([0.0, 0.0, 1.0], dtype=As.dtype))
    return w * scale[..., 0], v
