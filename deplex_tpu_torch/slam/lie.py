"""SO(3)/SE(3) Lie-group operations, batched over leading axes.

Port of ``deplex_tpu.slam.lie``. Closed-form and branch-free: the Taylor
fallbacks near zero are selected with ``torch.where``, so values and
forward-mode Jacobians (``torch.func.jacfwd``) stay finite at xi = 0, where
bundle adjustment differentiates.

Convention: xi[..., :3] = phi (rotation), xi[..., 3:] = rho (translation),
applied as T' = exp(xi) T on (R, t) pairs.
"""

from __future__ import annotations

import torch


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (A @ x[..., None])[..., 0]


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    one = torch.ones_like(theta2)
    # sin(t)/t and (1-cos t)/t^2 with series fallbacks near 0.
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    K = hat(phi)
    return _eye_like(K) + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (|phi| < pi).

    Near the identity every term comes from the skew vector w (|w| = 2 sin
    theta), since arccos has an infinite tangent at cos = 1."""
    # The scalars keep a trailing axis of 1: under torch.func.jacfwd a 0-d
    # tensor combined with a Python number gets a float64 tangent.
    trace = R[..., 0, 0:1] + R[..., 1, 1:2] + R[..., 2, 2:3]
    cos_t = (trace - 1.0) / 2.0
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    small = cos_t > 1.0 - 1e-6
    # The exact branch's arccos input stays away from +-1 where selected.
    cos_safe = torch.clamp(torch.where(small, torch.zeros_like(cos_t), cos_t),
                           -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_safe)
    scale_exact = theta / (2.0 * torch.sin(theta))
    s2 = torch.sum(w * w, dim=-1, keepdim=True) / 4.0
    scale_small = 0.5 + s2 / 12.0
    return w * torch.where(small, scale_small, scale_exact)


def se3_exp(xi: torch.Tensor):
    """(..., 6) twist (phi, rho) -> (R (..., 3, 3), t (..., 3))."""
    phi, rho = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    one = torch.ones_like(theta2)
    K = hat(phi)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.where(small, one, theta2 * theta))
    V = _eye_like(K) + b * K + c * (K @ K)
    return R, _matvec(V, rho)


def se3_apply(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to points p (..., 3)."""
    return _matvec(R, p) + t


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): first apply b, then a."""
    return Ra @ Rb, _matvec(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)
