"""Plane-landmark bundle adjustment with Schur-complement reduction.

Port of ``deplex_tpu.slam.ba``, dense (single-device) form. Variables: K
keyframe poses T_i = (R_i, t_i) (camera-from-world, pose 0 gauge-fixed) and
M landmarks eta_j (closest-point vectors). Observation (i, j) has the
residual [w_n (n_pred - n_obs), w_d (d_pred - d_obs)] of the landmark moved
into camera i. One Gauss-Newton step builds the normal equations, removes
the 3x3-block-diagonal landmark block in closed form (Schur complement),
solves the 6K x 6K pose system and back-substitutes the landmarks.

Optional motion priors (odometry edges between consecutive keyframes and
constant-velocity triples) carry the tracker's information into directions
that no observed plane normal spans. Jacobians come from
``torch.func.jacfwd`` of the closed-form residuals at xi = 0, vectorized
with ``torch.func.vmap``. The Levenberg-Marquardt loop accepts or rejects
each step with ``torch.where``: no host sync per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from deplex_tpu_torch.slam.lie import _matvec, se3_exp, so3_log
from deplex_tpu_torch.slam.planes import from_cp


class BAProblem(NamedTuple):
    """Static-shape BA inputs; invalid observation slots carry weight 0.
    odo_* and cv_w are None when the priors are absent."""

    R: torch.Tensor            # (K, 3, 3) initial rotations (camera-from-world)
    t: torch.Tensor            # (K, 3) initial translations
    eta: torch.Tensor          # (M, 3) initial landmark CP vectors
    obs_normal: torch.Tensor   # (K, P, 3) measured plane normals (camera frame)
    obs_d: torch.Tensor        # (K, P) measured offsets
    obs_lm: torch.Tensor       # (K, P) int64 landmark index (weight 0 if none)
    obs_w: torch.Tensor        # (K, P) observation weights (0 = empty slot)
    odo_R: torch.Tensor | None = None   # (K-1, 3, 3) measured R_i R_{i+1}^T
    odo_t: torch.Tensor | None = None   # (K-1, 3) measured t_i - R_rel t_{i+1}
    odo_w: torch.Tensor | None = None   # (K-1,) motion-prior weights
    cv_w: torch.Tensor | None = None    # (K-2,) constant-velocity prior weights


class BAState(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    eta: torch.Tensor
    cost: torch.Tensor


NORMAL_WEIGHT = 1000.0  # unitless normal residual vs raw-depth-unit offset
OFFSET_WEIGHT = 1.0     # (same balance as slam.odometry.estimate_pose)
HUBER_DELTA = 100.0     # robust scale on the weighted 4-residual norm
ODO_ROT_SCALE = 1000.0  # rad -> depth-unit-equivalent (as pose_graph)
ODO_TR_SCALE = 1.0


def _updated(xi, R, t):
    """Pose (R, t) after the left update exp(xi)."""
    dR, dt = se3_exp(xi)
    return dR @ R, _matvec(dR, t) + dt


def _obs_residual(xi, eta, Ri, ti, n_obs, d_obs):
    """4-residual of one observation, pose updated by xi."""
    R, t = _updated(xi, Ri, ti)
    n_w, d_w = from_cp(eta)
    n_c = _matvec(R, n_w)
    d_c = d_w - torch.sum(n_c * t, -1)
    # [None] before the scale: see lie.so3_log on 0-d tensors under jacfwd.
    return torch.cat([NORMAL_WEIGHT * (n_c - n_obs),
                      OFFSET_WEIGHT * (d_c - d_obs)[None]])


def _with_value(fn):
    """fn -> (fn, fn) so that jacfwd(..., has_aux=True) also returns fn."""
    def both(*args):
        r = fn(*args)
        return r, r
    return both


def _obs_terms(problem: BAProblem):
    """Residuals (K, P, 4) and Jacobians wrt the pose twist (K, P, 4, 6) and
    the landmark (K, P, 4, 3) of every observation slot."""
    K, P = problem.obs_d.shape
    M = problem.eta.shape[0]
    eta = problem.eta[torch.clamp(problem.obs_lm, 0, M - 1)].reshape(K * P, 3)
    R = problem.R[:, None].expand(K, P, 3, 3).reshape(K * P, 3, 3)
    t = problem.t[:, None].expand(K, P, 3).reshape(K * P, 3)
    xi0 = torch.zeros((K * P, 6), dtype=problem.t.dtype, device=problem.t.device)
    (Jp, Jl), r = vmap(jacfwd(_with_value(_obs_residual), argnums=(0, 1), has_aux=True))(
        xi0, eta, R, t, problem.obs_normal.reshape(K * P, 3), problem.obs_d.reshape(K * P))
    return r.reshape(K, P, 4), Jp.reshape(K, P, 4, 6), Jl.reshape(K, P, 4, 3)


def _obs_residuals(problem: BAProblem) -> torch.Tensor:
    """Residuals (K, P, 4) of every observation slot."""
    K, P = problem.obs_d.shape
    M = problem.eta.shape[0]
    n_w, d_w = from_cp(problem.eta[torch.clamp(problem.obs_lm, 0, M - 1)])
    n_c = (n_w @ problem.R.transpose(-1, -2))                       # (K, P, 3)
    d_c = d_w - torch.sum(n_c * problem.t[:, None, :], -1)
    return torch.cat([NORMAL_WEIGHT * (n_c - problem.obs_normal),
                      (OFFSET_WEIGHT * (d_c - problem.obs_d))[..., None]], -1)


def _accumulate(problem: BAProblem, M: int):
    """Normal-equation blocks of the observations: Hpp (K, 6, 6), bp (K, 6),
    Hll (M, 3, 3), bl (M, 3), Hpl (K, M, 6, 3) and the cost."""
    r, Jp, Jl = _obs_terms(problem)
    # Huber IRLS weight: observations far off (misassociations, fragments)
    # are downweighted instead of dragging the poses.
    r_norm = torch.sqrt(torch.sum(r * r, -1) + 1e-12)
    w = problem.obs_w * torch.clamp(HUBER_DELTA / r_norm, max=1.0)
    Hpp = torch.einsum("kp,kpia,kpib->kab", w, Jp, Jp)
    bp = torch.einsum("kp,kpia,kpi->ka", w, Jp, r)
    onehot = (problem.obs_lm[..., None] == torch.arange(M, device=w.device)
              ).to(r.dtype) * w[..., None]                          # (K, P, M)
    Hll = torch.einsum("kpm,kpia,kpib->mab", onehot, Jl, Jl)
    bl = torch.einsum("kpm,kpia,kpi->ma", onehot, Jl, r)
    Hpl = torch.einsum("kpm,kpia,kpib->kmab", onehot, Jp, Jl)
    cost = torch.sum(w * torch.sum(r * r, -1))
    return Hpp, bp, Hll, bl, Hpl, cost


def _odo_residual(xi_a, xi_b, Ra, ta, Rb, tb, mR, mt):
    """Weighted 6-residual of one consecutive-pose motion prior."""
    Ra2, ta2 = _updated(xi_a, Ra, ta)
    Rb2, tb2 = _updated(xi_b, Rb, tb)
    R_rel = Ra2 @ Rb2.mT
    t_rel = ta2 - _matvec(R_rel, tb2)
    r_rot = so3_log(mR.mT @ R_rel) * ODO_ROT_SCALE
    r_tr = (t_rel - mt) * ODO_TR_SCALE
    return torch.cat([r_rot, r_tr])


def _cv_residual(xi_a, xi_b, xi_c, Ra, ta, Rb, tb, Rc, tc):
    """Constant-velocity 6-residual over a pose triple (i-1, i, i+1): zero
    change of relative rotation and of camera-center velocity."""
    R_a, t_a = _updated(xi_a, Ra, ta)
    R_b, t_b = _updated(xi_b, Rb, tb)
    R_c, t_c = _updated(xi_c, Rc, tc)
    ca = -_matvec(R_a.mT, t_a)
    cb = -_matvec(R_b.mT, t_b)
    cc = -_matvec(R_c.mT, t_c)
    A = R_c @ R_b.mT
    B = R_b @ R_a.mT
    r_rot = so3_log(A @ B.mT) * ODO_ROT_SCALE
    r_tr = (cc - cb) - (cb - ca)
    return torch.cat([r_rot, r_tr])


def _cv_blocks(R_all, t_all, cv_w):
    """Jacobians (E, 3, 6, 6) (one per pose of triple e = (e, e+1, e+2)),
    residuals (E, 6) and cost of the constant-velocity priors."""
    E = cv_w.shape[0]
    zeros = torch.zeros((E, 6), dtype=t_all.dtype, device=t_all.device)
    (Ja, Jb, Jc), r = vmap(jacfwd(_with_value(_cv_residual), argnums=(0, 1, 2),
                                  has_aux=True))(
        zeros, zeros, zeros, R_all[:-2], t_all[:-2], R_all[1:-1], t_all[1:-1],
        R_all[2:], t_all[2:])
    return torch.stack([Ja, Jb, Jc], 1), r, torch.sum(cv_w * torch.sum(r * r, -1))


def _odo_blocks(R_all, t_all, odo_R, odo_t, odo_w):
    """Per-edge blocks of the motion priors, edge e coupling poses e, e+1:
    Haa, Hab, Hbb (E, 6, 6), ga, gb (E, 6) and the cost."""
    E = odo_w.shape[0]
    zeros = torch.zeros((E, 6), dtype=t_all.dtype, device=t_all.device)
    (Ja, Jb), r = vmap(jacfwd(_with_value(_odo_residual), argnums=(0, 1), has_aux=True))(
        zeros, zeros, R_all[:-1], t_all[:-1], R_all[1:], t_all[1:], odo_R, odo_t)
    w = odo_w[:, None, None]
    JaT, JbT = Ja.transpose(-1, -2), Jb.transpose(-1, -2)
    return (w * JaT @ Ja, w * JaT @ Jb, w * JbT @ Jb,
            odo_w[:, None] * _matvec(JaT, r), odo_w[:, None] * _matvec(JbT, r),
            torch.sum(odo_w * torch.sum(r * r, -1)))


def ba_step(problem: BAProblem, *, damping=1e-4, gauge_fix_first: bool = True) -> BAState:
    """One damped Gauss-Newton step with Schur elimination of the landmarks.
    damping: a float or a 0-d tensor."""
    K = problem.obs_d.shape[0]
    M = problem.eta.shape[0]
    dev, dt_ = problem.t.device, problem.t.dtype
    Hpp, bp, Hll, bl, Hpl, cost = _accumulate(problem, M)

    # Regularized landmark blocks: unobserved landmarks stay put.
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]

    # S[a, b] = delta_ab Hpp[a] - sum_j Hpl[a, j] Hll_inv[j] Hpl[b, j]^T
    W = torch.einsum("amkc,mcd->amkd", Hpl, Hll_inv)                 # (K, M, 6, 3)
    S = -torch.einsum("amkd,bmld->abkl", W, Hpl)                     # (K, K, 6, 6)
    g = bp - torch.einsum("amkd,md->ak", W, bl)                      # (K, 6)
    diag = torch.arange(K, device=dev)
    S[diag, diag] += Hpp

    # Motion priors: pose-only terms, added straight into the Schur system.
    if problem.odo_R is not None:
        Haa, Hab, Hbb, ga, gb, _ = _odo_blocks(problem.R, problem.t, problem.odo_R,
                                               problem.odo_t, problem.odo_w)
        idx = torch.arange(K - 1, device=dev)
        S[idx, idx] += Haa
        S[idx, idx + 1] += Hab
        S[idx + 1, idx] += Hab.transpose(-1, -2)
        S[idx + 1, idx + 1] += Hbb
        g[idx] += ga
        g[idx + 1] += gb
    if problem.cv_w is not None:
        J, r, _ = _cv_blocks(problem.R, problem.t, problem.cv_w)
        idx = torch.arange(K - 2, device=dev)
        w = problem.cv_w
        for a in range(3):
            g[idx + a] += torch.einsum("e,eik,ei->ek", w, J[:, a], r)
            for b in range(3):
                S[idx + a, idx + b] += torch.einsum("e,eik,eil->ekl", w, J[:, a], J[:, b])

    S[diag, diag] += damping * torch.eye(6, dtype=dt_, device=dev)
    if gauge_fix_first:
        # Pin pose 0: zero its rows and columns, identity diagonal, zero gradient.
        mask = (diag != 0).to(dt_)
        S = S * mask[:, None, None, None] * mask[None, :, None, None]
        S[0, 0] = torch.eye(6, dtype=dt_, device=dev)
        g = g * mask[:, None]
    Sd = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    dxp = -torch.linalg.solve_ex(Sd, g.reshape(-1, 1))[0].reshape(K, 6)

    # Landmark back-substitution: dx_l = -Hll_inv (bl + sum_a Hpl[a]^T dxp_a).
    rhs = torch.einsum("amkd,ak->md", Hpl, dxp)
    dxl = -torch.einsum("mcd,md->mc", Hll_inv, bl + rhs)

    R_new, t_new = _updated(dxp, problem.R, problem.t)
    return BAState(R=R_new, t=t_new, eta=problem.eta + dxl, cost=cost)


def ba_cost(problem: BAProblem) -> torch.Tensor:
    """Total robust cost: Huber on the observations plus the motion-prior
    quadratics, the objective whose IRLS weights ba_step uses."""
    r = _obs_residuals(problem)
    s = torch.sqrt(torch.sum(r * r, -1) + 1e-12)
    delta = HUBER_DELTA
    huber = torch.where(s <= delta, s * s, delta * (2.0 * s - delta))
    cost = torch.sum(problem.obs_w * huber)
    if problem.odo_R is not None:
        cost = cost + _odo_blocks(problem.R, problem.t, problem.odo_R,
                                  problem.odo_t, problem.odo_w)[-1]
    if problem.cv_w is not None:
        cost = cost + _cv_blocks(problem.R, problem.t, problem.cv_w)[-1]
    return cost


def run_ba(problem: BAProblem, *, iterations: int = 10, damping: float = 1e-4) -> BAState:
    """Levenberg-Marquardt BA, monotone in cost: a Gauss-Newton step is
    accepted only if it lowers the cost (damping / 3), else rejected
    (damping * 10); decided on the device."""
    lam = torch.tensor(damping, dtype=problem.t.dtype, device=problem.t.device)
    cost = ba_cost(problem)
    prob = problem
    for _ in range(iterations):
        cand = ba_step(prob, damping=lam)
        cand_prob = prob._replace(R=cand.R, t=cand.t, eta=cand.eta)
        new_cost = ba_cost(cand_prob)
        accept = new_cost < cost
        prob = prob._replace(R=torch.where(accept, cand.R, prob.R),
                             t=torch.where(accept, cand.t, prob.t),
                             eta=torch.where(accept, cand.eta, prob.eta))
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8), lam * 10.0)
        cost = torch.where(accept, new_cost, cost)
    return BAState(R=prob.R, t=prob.t, eta=prob.eta, cost=cost)


def pad_problem_keyframes(problem: BAProblem, K_pad: int) -> BAProblem:
    """Pad the keyframe axis to K_pad with inert keyframes: identity poses,
    zero-weight observations and priors, so they change no residual,
    Jacobian or cost (only the damping touches their diagonal)."""
    K = problem.obs_d.shape[0]
    if K_pad == K:
        return problem
    if K_pad < K:
        raise ValueError(f"K_pad {K_pad} < K {K}")
    pk = K_pad - K
    P = problem.obs_d.shape[1]

    def pad(x, *shape):
        return torch.cat([x, torch.zeros((pk, *shape), dtype=x.dtype, device=x.device)])

    def eye(x):
        return torch.cat([x, torch.eye(3, dtype=x.dtype, device=x.device).expand(pk, 3, 3)])

    out = problem._replace(R=eye(problem.R), t=pad(problem.t, 3),
                           obs_normal=pad(problem.obs_normal, P, 3),
                           obs_d=pad(problem.obs_d, P), obs_lm=pad(problem.obs_lm, P),
                           obs_w=pad(problem.obs_w, P))
    if problem.odo_R is not None:
        out = out._replace(odo_R=eye(problem.odo_R), odo_t=pad(problem.odo_t, 3),
                           odo_w=pad(problem.odo_w))
    if problem.cv_w is not None:
        out = out._replace(cv_w=pad(problem.cv_w))
    return out
