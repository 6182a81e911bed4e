"""Plane-landmark bundle adjustment with Schur-complement reduction.

Port of ``deplex_tpu.slam.ba``. Variables: K
keyframe poses T_i = (R_i, t_i) (camera-from-world, pose 0 gauge-fixed) and
M landmarks eta_j (closest-point vectors). Observation (i, j) has the
residual [w_n (n_pred - n_obs), w_d (d_pred - d_obs)] of the landmark moved
into camera i. One Gauss-Newton step builds the normal equations, removes
the 3x3-block-diagonal landmark block in closed form (Schur complement),
solves the 6K x 6K pose system and back-substitutes the landmarks.

``run_ba`` is the counterpart of the JAX package's compiled ``fori_loop``:
on a card its LM loop is one CUDA graph per signature (``compiled``), the
keyframe axis padded to a power-of-two bucket.
``run_ba_sharded`` shards the keyframe axis over the ranks of a
``torch.distributed`` mesh: ``ba_step``, ``ba_cost`` and the LM loop take a
process group, over which the landmark blocks are summed and the pose blocks
gathered (``parallel.distributed``). It runs op by op: its gloo collectives
are staged through the host, which a graph cannot record.

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
import torch.distributed as dist
from torch.func import jacfwd, vmap

from deplex_tpu_torch import compiled
from deplex_tpu_torch.parallel.distributed import all_gather_cat, all_reduce_sum
from deplex_tpu_torch.pipeline import full_float32
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


def ba_step(problem: BAProblem, *, damping=1e-4, gauge_fix_first: bool = True,
            group=None) -> BAState:
    """One damped Gauss-Newton step with Schur elimination of the landmarks.
    damping: a float or a 0-d tensor.

    group: a process group over which the KEYFRAME axis is sharded (this
    rank holds its slice of R, t and the observations, group-rank order;
    eta and the prior arrays are replicated). The landmark blocks, the cost
    and the back-substitution are summed over the group, the pose blocks
    gathered; every rank solves the same replicated 6K x 6K system and keeps
    its slice of the pose step. None: the dense step."""
    K = problem.obs_d.shape[0]
    M = problem.eta.shape[0]
    dev, dt_ = problem.t.device, problem.t.dtype
    Hpp, bp, Hll, bl, Hpl, cost = _accumulate(problem, M)
    if group is not None:
        Hll, bl, cost = (all_reduce_sum(x, group) for x in (Hll, bl, cost))
        Hpp_all, bp_all, Hpl_all = (all_gather_cat(x, group) for x in (Hpp, bp, Hpl))
    else:
        Hpp_all, bp_all, Hpl_all = Hpp, bp, Hpl
    Kg = bp_all.shape[0]

    # Regularized landmark blocks: unobserved landmarks stay put.
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]

    # S[a, b] = delta_ab Hpp[a] - sum_j Hpl[a, j] Hll_inv[j] Hpl[b, j]^T
    W = torch.einsum("amkc,mcd->amkd", Hpl_all, Hll_inv)             # (Kg, M, 6, 3)
    S = -torch.einsum("amkd,bmld->abkl", W, Hpl_all)                 # (Kg, Kg, 6, 6)
    g = bp_all - torch.einsum("amkd,md->ak", W, bl)                  # (Kg, 6)
    diag = torch.arange(Kg, device=dev)
    S[diag, diag] += Hpp_all

    # Motion priors: pose-only terms, added straight into the Schur system;
    # their chains cross shard boundaries, so the poses are gathered.
    if problem.odo_R is not None or problem.cv_w is not None:
        R_all, t_all = _all_poses(problem, group)
    if problem.odo_R is not None:
        Haa, Hab, Hbb, ga, gb, _ = _odo_blocks(R_all, t_all, problem.odo_R,
                                               problem.odo_t, problem.odo_w)
        idx = torch.arange(Kg - 1, device=dev)
        S[idx, idx] += Haa
        S[idx, idx + 1] += Hab
        S[idx + 1, idx] += Hab.transpose(-1, -2)
        S[idx + 1, idx + 1] += Hbb
        g[idx] += ga
        g[idx + 1] += gb
    if problem.cv_w is not None:
        J, r, _ = _cv_blocks(R_all, t_all, problem.cv_w)
        idx = torch.arange(Kg - 2, device=dev)
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
    Sd = S.permute(0, 2, 1, 3).reshape(Kg * 6, Kg * 6)
    dxp = -torch.linalg.solve_ex(Sd, g.reshape(-1, 1))[0].reshape(Kg, 6)
    if group is not None:
        i0 = dist.get_rank(group) * K
        dxp = dxp[i0:i0 + K]

    # Landmark back-substitution: dx_l = -Hll_inv (bl + sum_a Hpl[a]^T dxp_a).
    rhs = torch.einsum("amkd,ak->md", Hpl, dxp)
    if group is not None:
        rhs = all_reduce_sum(rhs, group)
    dxl = -torch.einsum("mcd,md->mc", Hll_inv, bl + rhs)

    R_new, t_new = _updated(dxp, problem.R, problem.t)
    return BAState(R=R_new, t=t_new, eta=problem.eta + dxl, cost=cost)


def _all_poses(problem: BAProblem, group):
    """Every keyframe's (R, t): this rank's, or the group's gathered."""
    if group is None:
        return problem.R, problem.t
    return all_gather_cat(problem.R, group), all_gather_cat(problem.t, group)


def ba_cost(problem: BAProblem, *, group=None) -> torch.Tensor:
    """Total robust cost: Huber on the observations plus the motion-prior
    quadratics, the objective whose IRLS weights ba_step uses. group: as in
    ba_step; the observation cost is summed over the ranks and the
    (replicated) prior cost added once."""
    r = _obs_residuals(problem)
    s = torch.sqrt(torch.sum(r * r, -1) + 1e-12)
    delta = HUBER_DELTA
    huber = torch.where(s <= delta, s * s, delta * (2.0 * s - delta))
    cost = torch.sum(problem.obs_w * huber)
    if group is not None:
        cost = all_reduce_sum(cost, group)
    if problem.odo_R is not None or problem.cv_w is not None:
        R_all, t_all = _all_poses(problem, group)
    if problem.odo_R is not None:
        cost = cost + _odo_blocks(R_all, t_all, problem.odo_R,
                                  problem.odo_t, problem.odo_w)[-1]
    if problem.cv_w is not None:
        cost = cost + _cv_blocks(R_all, t_all, problem.cv_w)[-1]
    return cost


def _lm_loop(problem: BAProblem, iterations: int, lam: torch.Tensor, group) -> BAState:
    """The Levenberg-Marquardt loop from the damping `lam` (a 0-d tensor on
    the problem's device): a step is accepted only if it lowers the cost
    (damping / 3), else rejected (damping * 10); decided on the device.
    With a group, the cost is summed over it and the solve sees gathered
    inputs, so every rank takes the same decisions in lock step."""
    cost = ba_cost(problem, group=group)
    prob = problem
    for _ in range(iterations):
        cand = ba_step(prob, damping=lam, group=group)
        cand_prob = prob._replace(R=cand.R, t=cand.t, eta=cand.eta)
        new_cost = ba_cost(cand_prob, group=group)
        accept = new_cost < cost
        prob = prob._replace(R=torch.where(accept, cand.R, prob.R),
                             t=torch.where(accept, cand.t, prob.t),
                             eta=torch.where(accept, cand.eta, prob.eta))
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-8), lam * 10.0)
        cost = torch.where(accept, new_cost, cost)
    return BAState(R=prob.R, t=prob.t, eta=prob.eta, cost=cost)


def _damping(problem: BAProblem, damping: float) -> torch.Tensor:
    """The initial damping as a 0-d tensor on the problem's device (a fill:
    no copy from host memory)."""
    return torch.full((), damping, dtype=problem.t.dtype, device=problem.t.device)


def run_ba(problem: BAProblem, *, iterations: int = 10, damping: float = 1e-4) -> BAState:
    """Levenberg-Marquardt BA, monotone in cost: a Gauss-Newton step is
    accepted only if it lowers the cost (damping / 3), else rejected
    (damping * 10); decided on the device. Runs without TF32 on the card.

    The keyframe axis is padded to its bucket (``compiled.bucket``) with
    inert keyframes (``pad_problem_keyframes``), so that a growing map meets
    few shapes; the result is cut back to the K keyframes. On a card the
    loop is one CUDA graph per key (``compiled`` entry "run_ba", eager_once:
    `iterations`, the priors present, the bucket); the padded problem's
    tensors and the damping are its inputs, so a new damping replays it."""
    K = problem.R.shape[0]
    padded = pad_problem_keyframes(problem, compiled.bucket(K))
    fields = tuple(f for f in BAProblem._fields if getattr(padded, f) is not None)

    def dense(*args):
        *tensors, lam = args
        return _lm_loop(BAProblem(**dict(zip(fields, tensors))), iterations, lam, None)

    with full_float32(problem.R.device):
        out = compiled.call("run_ba", dense,
                            (*(getattr(padded, f) for f in fields), _damping(problem, damping)),
                            (iterations, fields), eager_once=True)
    return out._replace(R=out.R[:K], t=out.t[:K])


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


def run_ba_sharded(problem: BAProblem, mesh=None, *, axis: str = "kf",
                   iterations: int = 10, damping: float = 1e-4) -> BAState:
    """run_ba with the KEYFRAME axis sharded over the `axis` ranks of a
    DeviceMesh (None: a 1-D mesh over the initialized world).

    Every rank passes the whole problem. It is padded with inert keyframes
    (pad_problem_keyframes) to run_ba's bucket, rounded up to a multiple of
    the axis size, so that it solves run_ba's padded problem; each rank keeps
    its K/n keyframes' observations and does their Jacobian and outer-product
    work, the Schur blocks combine over the group (ba_step), and the summed
    cost keeps the damping schedule in lock step. Landmarks and the prior
    arrays stay replicated. Every rank returns the whole unpadded BAState,
    equal to run_ba's to Gauss-Newton accuracy (the sums run in another
    order). Op by op, also on a card: the collectives go through gloo's host
    staging on one card, which a CUDA graph cannot record."""
    from torch.distributed.device_mesh import DeviceMesh

    from deplex_tpu_torch.parallel.distributed import make_mesh

    if mesh is None:
        mesh = make_mesh(axis)
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got {type(mesh).__name__}")
    group = mesh.get_group(axis)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    K = problem.obs_d.shape[0]
    Kp = -(-compiled.bucket(K) // n) * n
    prob = pad_problem_keyframes(problem, Kp)
    lo, hi = rank * (Kp // n), (rank + 1) * (Kp // n)
    local = prob._replace(R=prob.R[lo:hi], t=prob.t[lo:hi], obs_normal=prob.obs_normal[lo:hi],
                          obs_d=prob.obs_d[lo:hi], obs_lm=prob.obs_lm[lo:hi],
                          obs_w=prob.obs_w[lo:hi])
    with full_float32(problem.R.device):
        out = _lm_loop(local, iterations, _damping(problem, damping), group)
    return BAState(R=all_gather_cat(out.R, group)[:K], t=all_gather_cat(out.t, group)[:K],
                   eta=out.eta, cost=out.cost)
