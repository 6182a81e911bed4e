"""Plane-based pose estimation (frame-to-map odometry).

Port of ``deplex_tpu.slam.odometry``: Gauss-Newton on the plane residual

    r = [ w_n * (R n_w - n_obs) ;  w_d * (d_w - (R n_w) . t - d_obs) ]

for a fixed number of iterations, Huber-weighted, with Marquardt damping and
a 6x6 solve (``torch.linalg.solve_ex``: no host sync for its error check).
Every argument may carry leading batch axes (one problem per pose-graph
edge, say); the single-frame form has none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deplex_tpu_torch.slam.lie import _matvec, se3_exp
from deplex_tpu_torch.slam.planes import PlaneObs


class OdometryResult(NamedTuple):
    R: torch.Tensor            # (..., 3, 3) camera-from-world rotation
    t: torch.Tensor            # (..., 3) camera-from-world translation
    num_inliers: torch.Tensor  # (...) matches with weight > 0
    residual: torch.Tensor     # (...) final weighted squared residual


def estimate_pose(obs: PlaneObs, lm_normal: torch.Tensor, lm_d: torch.Tensor,
                  match_lm: torch.Tensor, match_valid: torch.Tensor,
                  R0: torch.Tensor, t0: torch.Tensor, *, iterations: int = 8,
                  damping: float = 1e-3, normal_weight: float = 1000.0,
                  offset_weight: float = 1.0) -> OdometryResult:
    """Gauss-Newton refinement of (R0, t0) from matched planes.

    obs: (..., P) observations; lm_*: (..., M) world landmarks; match_lm
    (..., P) landmark index per observation (-1 = none), match_valid bool."""
    idx = torch.clamp(match_lm.to(torch.int64), 0, lm_d.shape[-1] - 1)
    n_w = torch.gather(lm_normal, -2, idx[..., None].expand(*idx.shape, 3))
    d_w = torch.gather(lm_d, -1, idx)
    # Support-weighted (sqrt: one huge plane must not dominate), normalized
    # so that H is O(1).
    w = torch.where(match_valid & (obs.weight > 0),
                    torch.sqrt(torch.clamp(obs.weight, min=0.0)),
                    torch.zeros_like(obs.weight))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    wn, wd = normal_weight, offset_weight

    def residuals(R, t):
        n_pred = n_w @ R.transpose(-1, -2)                 # (..., P, 3)
        d_pred = d_w - (n_pred @ t[..., None])[..., 0]     # (..., P)
        return (n_pred - obs.normal) * wn, (d_pred - obs.d) * wd, n_pred

    R, t = R0, t0
    for _ in range(iterations):
        rn, rd, n_pred = residuals(R, t)
        # Huber: matches far off (misassociations) are downweighted.
        r_norm = torch.sqrt(torch.sum(rn * rn, -1) + rd * rd + 1e-12)
        w_rob = w * torch.clamp(100.0 / r_norm, max=1.0)
        # Jacobians wrt xi = (phi, rho), update on the left: R' = exp(phi) R.
        px, py, pz = n_pred[..., 0], n_pred[..., 1], n_pred[..., 2]
        zeros = torch.zeros_like(px)
        Jn_phi = torch.stack([                             # -hat(n_pred)
            torch.stack([zeros, pz, -py], -1),
            torch.stack([-pz, zeros, px], -1),
            torch.stack([py, -px, zeros], -1),
        ], -2) * wn
        Jd_phi = torch.linalg.cross(n_pred, t[..., None, :].expand_as(n_pred)) * wd
        Jd_rho = -n_pred * wd
        Jn = torch.cat([Jn_phi, torch.zeros_like(Jn_phi)], dim=-1)   # (..., P, 3, 6)
        Jd = torch.cat([Jd_phi, Jd_rho], dim=-1)                      # (..., P, 6)
        H = (torch.einsum("...p,...pik,...pil->...kl", w_rob, Jn, Jn)
             + torch.einsum("...p,...pk,...pl->...kl", w_rob, Jd, Jd))
        b = (torch.einsum("...p,...pik,...pi->...k", w_rob, Jn, rn)
             + torch.einsum("...p,...pk,...p->...k", w_rob, Jd, rd))
        # Marquardt damping, relative per parameter, with a tiny floor.
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        floor = 1e-8 * torch.clamp(diag.max(-1, keepdim=True).values, min=1.0)
        H = H + torch.diag_embed(damping * diag + floor)
        xi = -torch.linalg.solve_ex(H, b[..., None])[0][..., 0]
        xi = torch.where(torch.isfinite(xi), xi, torch.zeros_like(xi))
        dR, dt = se3_exp(xi)
        R, t = dR @ R, _matvec(dR, t) + dt

    rn, rd, _ = residuals(R, t)
    res = torch.sum(w * (torch.sum(rn * rn, -1) + rd * rd), -1)
    n_used = torch.sum((w > 0).to(torch.int32), -1)
    return OdometryResult(R=R, t=t, num_inliers=n_used, residual=res)
