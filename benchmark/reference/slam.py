"""Plane-landmark SLAM tracking in plain PyTorch: the reference the benchmark
holds ``PlaneSlam.process_frame``'s poses and matches to.

A frozen copy of the port's tracking step: ``slam/lie.py`` (``hat``,
``so3_exp``, ``se3_exp``), ``slam/planes.py``, ``slam/association.py``,
``slam/odometry.py`` and ``slam/frontend.py``'s ``init_map``,
``extract_plane_obs`` and ``slam_step``, with stages 1-4 taken from this
package's copies of the plane stages (``cellstats``, ``growing``,
``merge``) on the clouds of ``stages.backproject``. Plain PyTorch, float32
with TF32 off, nothing imported from the port. The arithmetic is the
port's, operation for operation. The departures:

- ``plane_obs`` runs stages 1-4 on a batch of frames at once (the port runs
  one frame a call); every frame's planes are computed on their own, as in
  the plane cells' reference.
- ``track`` is the session that ``PlaneSlam`` drives frame by frame (an
  empty map, the identity pose, each frame's step from the last one's pose
  and map); it keeps no trajectory, keyframes or backends.
- ``precision.operand`` around the operands of every matrix product, the
  identity outside ``precision.tf32()`` (the control's TF32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.cellstats import cell_moments_reference, patch_size
from benchmark.reference.config import Config
from benchmark.reference.growing import finalize_cells, finalize_grown, grow_rounds_loop, \
    unpack_edges
from benchmark.reference.merge import merge_planes_from_labels
from benchmark.reference.precision import operand
from benchmark.reference.stages import backproject, full_float32


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, each operand as the current precision sees it."""
    return operand(a) @ operand(b)


# --- slam/lie.py ---------------------------------------------------------------

def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return _mm(A, x[..., None])[..., 0]


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
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    K = hat(phi)
    return _eye_like(K) + a * K + b * _mm(K, K)


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
    V = _eye_like(K) + b * K + c * _mm(K, K)
    return R, _matvec(V, rho)


# --- slam/planes.py ------------------------------------------------------------

class PlaneObs(NamedTuple):
    """Fixed-capacity per-frame plane observations (camera frame)."""

    normal: torch.Tensor   # (MAXP, 3) unit normals
    d: torch.Tensor        # (MAXP,) offsets (n.x + d = 0)
    weight: torch.Tensor   # (MAXP,) point-count weights; 0 = empty slot
    mean: torch.Tensor     # (MAXP, 3) centroids


def to_cp(normal: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(n, d) -> closest-point vector eta = -d n."""
    return -d[..., None] * normal


def from_cp(eta: torch.Tensor):
    """eta -> (n, d) with d = |eta| >= 0, n = -eta / |eta|; eta ~ 0 gets n = +z."""
    d = torch.linalg.vector_norm(eta, dim=-1)
    safe = d > 1e-12
    n = torch.where(safe[..., None],
                    -eta / torch.where(safe, d, torch.ones_like(d))[..., None],
                    torch.eye(3, dtype=eta.dtype, device=eta.device)[2])
    return n, d


def transform_plane(R: torch.Tensor, t: torch.Tensor, n_w: torch.Tensor, d_w: torch.Tensor):
    """World plane -> camera plane under x_c = R x_w + t."""
    n_c = _matvec(R, n_w)
    d_c = d_w - torch.sum(n_c * t, dim=-1)
    return n_c, d_c


def untransform_plane(R: torch.Tensor, t: torch.Tensor, n_c: torch.Tensor, d_c: torch.Tensor):
    """Camera plane -> world plane (inverse of transform_plane)."""
    n_w = _matvec(R.transpose(-1, -2), n_c)
    d_w = d_c + torch.sum(n_c * t, dim=-1)
    return n_w, d_w


# --- slam/association.py -------------------------------------------------------

class AssociationParams(NamedTuple):
    """Match and landmark-spawn gates (the port's defaults)."""

    min_cos_angle: float = 0.95
    max_offset_dist: float = 200.0
    max_point_dist: float = 200.0
    dup_cos_angle: float = 0.85
    dup_offset_dist: float = 300.0


class Matches(NamedTuple):
    landmark: torch.Tensor   # (MAXP,) int32 landmark index, -1 = unmatched
    valid: torch.Tensor      # (MAXP,) bool


def associate(obs: PlaneObs, lm_normal: torch.Tensor, lm_d: torch.Tensor,
              lm_valid: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
              params: AssociationParams = AssociationParams()) -> Matches:
    """Greedy one-to-one association, best score first (ties to the first
    row-major index); (R, t) the camera-from-world pose prior."""
    MAXP = obs.d.shape[0]
    n_pred, d_pred = transform_plane(R, t, lm_normal, lm_d)
    M = d_pred.shape[0]

    cos = _mm(obs.normal, n_pred.T)
    d_diff = torch.abs(obs.d[:, None] - d_pred[None, :])
    pt_dist = torch.abs(_mm(obs.mean, n_pred.T) + d_pred[None, :])
    ok = ((cos >= params.min_cos_angle)
          & (d_diff <= params.max_offset_dist)
          & (pt_dist <= params.max_point_dist)
          & (obs.weight > 0)[:, None]
          & lm_valid[None, :])
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
        have = torch.isfinite(score.reshape(-1).gather(0, flat.reshape(1))).reshape(())
        lm_of_obs = torch.where(have & (rows == p), m, lm_of_obs)
        taken = (rows[:, None] == p) | (cols[None, :] == m)
        score = torch.where(have & taken, inf, score)
    lm_of_obs = lm_of_obs.to(torch.int32)
    return Matches(landmark=lm_of_obs, valid=lm_of_obs >= 0)


# --- slam/odometry.py ----------------------------------------------------------

def estimate_pose(obs: PlaneObs, lm_normal: torch.Tensor, lm_d: torch.Tensor,
                  match_lm: torch.Tensor, match_valid: torch.Tensor,
                  R0: torch.Tensor, t0: torch.Tensor, *, iterations: int = 8,
                  damping: float = 1e-3, normal_weight: float = 1000.0,
                  offset_weight: float = 1.0):
    """Gauss-Newton refinement of (R0, t0) from matched planes, Huber
    weighted, Marquardt damped, a 6x6 solve an iteration. Returns (R, t)."""
    idx = torch.clamp(match_lm.to(torch.int64), 0, lm_d.shape[-1] - 1)
    n_w = torch.gather(lm_normal, -2, idx[..., None].expand(*idx.shape, 3))
    d_w = torch.gather(lm_d, -1, idx)
    w = torch.where(match_valid & (obs.weight > 0),
                    torch.sqrt(torch.clamp(obs.weight, min=0.0)),
                    torch.zeros_like(obs.weight))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    wn, wd = normal_weight, offset_weight

    def residuals(R, t):
        n_pred = _mm(n_w, R.transpose(-1, -2))
        d_pred = d_w - _mm(n_pred, t[..., None])[..., 0]
        return (n_pred - obs.normal) * wn, (d_pred - obs.d) * wd, n_pred

    def einsum(eq, *xs):
        return torch.einsum(eq, *(operand(x) for x in xs))

    R, t = R0, t0
    for _ in range(iterations):
        rn, rd, n_pred = residuals(R, t)
        r_norm = torch.sqrt(torch.sum(rn * rn, -1) + rd * rd + 1e-12)
        w_rob = w * torch.clamp(100.0 / r_norm, max=1.0)
        px, py, pz = n_pred[..., 0], n_pred[..., 1], n_pred[..., 2]
        zeros = torch.zeros_like(px)
        Jn_phi = torch.stack([
            torch.stack([zeros, pz, -py], -1),
            torch.stack([-pz, zeros, px], -1),
            torch.stack([py, -px, zeros], -1),
        ], -2) * wn
        Jd_phi = torch.linalg.cross(n_pred, t[..., None, :].expand_as(n_pred)) * wd
        Jd_rho = -n_pred * wd
        Jn = torch.cat([Jn_phi, torch.zeros_like(Jn_phi)], dim=-1)
        Jd = torch.cat([Jd_phi, Jd_rho], dim=-1)
        H = (einsum("...p,...pik,...pil->...kl", w_rob, Jn, Jn)
             + einsum("...p,...pk,...pl->...kl", w_rob, Jd, Jd))
        b = (einsum("...p,...pik,...pi->...k", w_rob, Jn, rn)
             + einsum("...p,...pk,...p->...k", w_rob, Jd, rd))
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        floor = 1e-8 * torch.clamp(diag.max(-1, keepdim=True).values, min=1.0)
        H = H + torch.diag_embed(damping * diag + floor)
        xi = -torch.linalg.solve_ex(H, b[..., None])[0][..., 0]
        xi = torch.where(torch.isfinite(xi), xi, torch.zeros_like(xi))
        dR, dt = se3_exp(xi)
        R, t = _mm(dR, R), _matvec(dR, t) + dt
    return R, t


# --- slam/frontend.py ----------------------------------------------------------

class MapState(NamedTuple):
    """Fixed-capacity plane-landmark map (world frame)."""

    normal: torch.Tensor    # (M, 3)
    d: torch.Tensor         # (M,)
    weight: torch.Tensor    # (M,) accumulated observation weight; 0 = free slot
    count: torch.Tensor     # () int32 occupied slots


class FrameResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    num_matched: torch.Tensor
    num_new: torch.Tensor
    obs: PlaneObs
    matches_lm: torch.Tensor


def init_map(max_landmarks: int, device) -> MapState:
    return MapState(normal=torch.zeros((max_landmarks, 3), device=device),
                    d=torch.zeros(max_landmarks, device=device),
                    weight=torch.zeros(max_landmarks, device=device),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def plane_obs(points: torch.Tensor, image_height: int, image_width: int,
              config: Config) -> list[PlaneObs]:
    """Stages 1-4 on (B, H*W, 3) organized clouds -> each frame's merged
    planes as PlaneObs; slots absorbed by the merge (and empty ones) get
    weight 0, so each plane appears once."""
    B = points.shape[0]
    pts = points.to(torch.float32).reshape(B, image_height, image_width, 3).contiguous()
    P = patch_size(image_height, image_width, config)
    moments = cell_moments_reference(pts, None, config)
    cells = finalize_cells(moments, P, config)
    edges, _ = unpack_edges(cells.edges)
    round_map, seeds, nr_rounds = grow_rounds_loop(cells.bins, cells.stats.mse, edges,
                                                   cells.stats.planar, config)
    _, labels_map, segments = finalize_grown(round_map, seeds, nr_rounds, cells.stats, config)
    merge_labels, merged = merge_planes_from_labels(labels_map, segments, config)
    M = merge_labels.shape[1]
    slots = torch.arange(M, device=pts.device)
    out = []
    for b in range(B):
        occupied = slots < merged.nr_planes[b]
        w = torch.where(occupied, merged.n[b], torch.zeros_like(merged.n[b]))
        keep = merge_labels[b] == slots
        out.append(PlaneObs(normal=merged.normal[b], d=merged.d[b],
                            weight=torch.where(keep, w, torch.zeros_like(w)),
                            mean=merged.mean[b]))
    return out


def slam_step(obs: PlaneObs, map_state: MapState, R_prior: torch.Tensor,
              t_prior: torch.Tensor, *, assoc: AssociationParams,
              odom_iterations: int, min_obs_weight: float):
    """Associate -> pose Gauss-Newton -> fuse and spawn. Returns
    (FrameResult, the new MapState)."""
    dev = obs.d.device
    usable = obs._replace(weight=torch.where(obs.weight >= min_obs_weight, obs.weight,
                                             torch.zeros_like(obs.weight)))
    matches = associate(usable, map_state.normal, map_state.d, map_state.weight > 0,
                        R_prior, t_prior, assoc)
    R, t = estimate_pose(usable, map_state.normal, map_state.d, matches.landmark,
                         matches.valid, R_prior, t_prior, iterations=odom_iterations)

    # Fuse matched observations: the weighted mean of CP vectors, in the world.
    n_w_obs, d_w_obs = untransform_plane(R, t, usable.normal, usable.d)
    M = map_state.d.shape[0]
    slots = torch.arange(M, device=dev)
    onehot = ((matches.landmark.to(torch.int64)[:, None] == slots[None, :])
              & matches.valid[:, None]).to(torch.float32)
    w_obs = onehot * usable.weight[:, None]
    add_w = w_obs.sum(0)
    cp_obs = to_cp(n_w_obs, d_w_obs)
    cp_map = to_cp(map_state.normal, map_state.d)
    tot_w = map_state.weight + add_w
    cp_new = ((cp_map * map_state.weight[:, None] + _mm(w_obs.T, cp_obs))
              / torch.clamp(tot_w, min=1.0)[:, None])
    cp_new = torch.where((add_w > 0)[:, None], cp_new, cp_map)
    n_new, d_new = from_cp(cp_new)
    fused = MapState(normal=n_new, d=d_new,
                     weight=torch.where(add_w > 0, tot_w, map_state.weight),
                     count=map_state.count)

    # Spawn landmarks for unmatched observations that duplicate none.
    dup_cos = _mm(n_w_obs, fused.normal.T)
    dup_d = torch.abs(d_w_obs[:, None] - fused.d[None, :])
    near_dup = ((dup_cos >= assoc.dup_cos_angle) & (dup_d <= assoc.dup_offset_dist)
                & (fused.weight > 0)[None, :]).any(1)
    unmatched = (usable.weight > 0) & ~matches.valid & ~near_dup
    order = torch.cumsum(unmatched.to(torch.int32), 0) - 1
    slot = fused.count + order
    can = unmatched & (slot < M)
    spawn = (torch.clamp(slot, 0, M - 1)[:, None] == slots[None, :]) & can[:, None]
    spawned = spawn.any(0)
    src = torch.argmax(spawn.to(torch.int32), 0)
    new_map = MapState(
        normal=torch.where(spawned[:, None], n_w_obs[src], fused.normal),
        d=torch.where(spawned, d_w_obs[src], fused.d),
        weight=torch.where(spawned, usable.weight[src], fused.weight),
        count=fused.count + can.sum().to(torch.int32))
    result = FrameResult(R=R, t=t, num_matched=matches.valid.sum().to(torch.int32),
                         num_new=can.sum().to(torch.int32), obs=usable,
                         matches_lm=torch.where(matches.valid, matches.landmark,
                                                torch.full_like(matches.landmark, -1)))
    return result, new_map


def track(depth: torch.Tensor, K: torch.Tensor, config: Config, *, max_landmarks: int,
          odom_iterations: int = 8, min_obs_weight: float = 0.0,
          assoc: AssociationParams = AssociationParams()):
    """One session from an empty map and the identity pose over (N, H, W)
    uint16 depth frames and a 3x3 float32 K, on the frames' device; stages
    1-4 on all N frames at once. Returns ([FrameResult] a frame, the final
    MapState)."""
    N, H, W = depth.shape
    dev = depth.device
    with full_float32():
        obs = plane_obs(backproject(depth, K.to(dev)), H, W, config)
        state = init_map(max_landmarks, dev)
        R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        results = []
        for o in obs:
            res, state = slam_step(o, state, R, t, assoc=assoc, odom_iterations=odom_iterations,
                                   min_obs_weight=min_obs_weight)
            R, t = res.R, res.t
            results.append(res)
    return results, state
