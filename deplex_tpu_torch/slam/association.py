"""Frame-to-map plane association.

Port of ``deplex_tpu.slam.association``. The landmarks are moved into the
camera with the pose prior; every observation-landmark pair gets a gated
score (normal angle, offset, centroid-to-plane distance), and a greedy
one-to-one pass takes the best remaining pair MAXP times. The pass runs on
the device without a host sync: a step that finds no finite score changes
nothing (``torch.where``), and ties go to the first row-major index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deplex_tpu_torch.slam.planes import PlaneObs, transform_plane


class AssociationParams(NamedTuple):
    """Match and landmark-spawn gates (the reference package's values; its
    module documents how they were chosen)."""

    min_cos_angle: float = 0.95      # normal agreement gate
    max_offset_dist: float = 200.0   # |d_obs - d_pred| gate (depth units, mm)
    max_point_dist: float = 200.0    # centroid-to-predicted-plane gate (mm)
    dup_cos_angle: float = 0.85      # near-duplicate normal gate for spawning
    dup_offset_dist: float = 300.0   # near-duplicate offset gate for spawning


class Matches(NamedTuple):
    landmark: torch.Tensor   # (MAXP,) int32 landmark index, -1 = unmatched
    valid: torch.Tensor      # (MAXP,) bool: the observation has a match


def associate(obs: PlaneObs, lm_normal: torch.Tensor, lm_d: torch.Tensor,
              lm_valid: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
              params: AssociationParams = AssociationParams()) -> Matches:
    """Greedy one-to-one association, best score first.

    obs: camera-frame observations; lm_*: (M,) world landmarks; (R, t): the
    camera-from-world pose prior."""
    MAXP = obs.d.shape[0]
    n_pred, d_pred = transform_plane(R, t, lm_normal, lm_d)       # (M, 3), (M,)
    M = d_pred.shape[0]

    cos = obs.normal @ n_pred.T
    d_diff = torch.abs(obs.d[:, None] - d_pred[None, :])
    pt_dist = torch.abs(obs.mean @ n_pred.T + d_pred[None, :])
    ok = ((cos >= params.min_cos_angle)
          & (d_diff <= params.max_offset_dist)
          & (pt_dist <= params.max_point_dist)
          & (obs.weight > 0)[:, None]
          & lm_valid[None, :])
    # Lower is better: the combined normalized distance.
    score = torch.where(
        ok,
        (1.0 - cos) / max(1.0 - params.min_cos_angle, 1e-6)
        + d_diff / params.max_offset_dist + pt_dist / params.max_point_dist,
        torch.full_like(cos, float("inf")))

    rows = torch.arange(MAXP, device=score.device)
    cols = torch.arange(M, device=score.device)
    lm_of_obs = torch.full((MAXP,), -1, dtype=torch.int64, device=score.device)
    inf = torch.full((), float("inf"), device=score.device)
    for _ in range(MAXP):
        flat = torch.argmin(score.reshape(-1))
        p, m = flat // M, flat % M
        # gather, not score[flat]: a 0-d index tensor is read on the host.
        have = torch.isfinite(score.reshape(-1).gather(0, flat.reshape(1))).reshape(())
        lm_of_obs = torch.where(have & (rows == p), m, lm_of_obs)
        taken = (rows[:, None] == p) | (cols[None, :] == m)
        score = torch.where(have & taken, inf, score)
    lm_of_obs = lm_of_obs.to(torch.int32)
    return Matches(landmark=lm_of_obs, valid=lm_of_obs >= 0)
