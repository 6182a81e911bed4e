"""Pose-graph optimization over SE(3) relative-pose constraints.

Port of ``deplex_tpu.slam.pose_graph``, dense form. Nodes are keyframe
poses, edges carry measured relative transforms; the residual of edge (a, b)
is the so3_log of the rotation error (scaled by ROT_SCALE) and the
translation error in a's frame. Gauss-Newton with ``torch.func.jacfwd``
Jacobians, Huber-weighted edges, optional constant-velocity priors, node 0
gauge-fixed, a dense (6K x 6K) solve and a per-node trust region.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from deplex_tpu_torch.slam.ba import _updated, _with_value
from deplex_tpu_torch.slam.lie import _matvec, se3_exp, so3_log


class PoseGraph(NamedTuple):
    R: torch.Tensor        # (K, 3, 3) node rotations
    t: torch.Tensor        # (K, 3)
    edge_a: torch.Tensor   # (E,) int64 source node
    edge_b: torch.Tensor   # (E,) int64 target node
    meas_R: torch.Tensor   # (E, 3, 3) measured R_a^-1 R_b
    meas_t: torch.Tensor   # (E, 3) measured t in a's frame
    weight: torch.Tensor   # (E,) edge weights, 0 = padding
    cv_w: torch.Tensor | None = None  # (K-2,) constant-velocity prior weights


# 1 rad of rotation error weighs like 1000 depth units (mm) of translation:
# the displacement rotating an indoor scene a few meters deep induces.
ROT_SCALE = 1000.0
# Huber scale on the scaled 6-residual norm (translation units).
HUBER_DELTA = 50.0


def _edge_residual(Ra, ta, Rb, tb, mR, mt):
    """Scaled 6-residual of one edge given node poses."""
    R_ab = Ra.mT @ Rb
    t_ab = _matvec(Ra.mT, tb - ta)
    r_rot = so3_log(mR.mT @ R_ab) * ROT_SCALE
    return torch.cat([r_rot, t_ab - mt])


def _edge_residual_wrt_updates(xi_a, xi_b, Ra, ta, Rb, tb, mR, mt):
    Ra2, ta2 = _updated(xi_a, Ra, ta)
    Rb2, tb2 = _updated(xi_b, Rb, tb)
    return _edge_residual(Ra2, ta2, Rb2, tb2, mR, mt)


def _cv_residual(xi_a, xi_b, xi_c, Ra, ta, Rb, tb, Rc, tc):
    """Constant-velocity prior over a node triple in this module's
    world-from-camera convention (the camera center is t)."""
    R_a, t_a = _updated(xi_a, Ra, ta)
    R_b, t_b = _updated(xi_b, Rb, tb)
    R_c, t_c = _updated(xi_c, Rc, tc)
    r_rot = so3_log((R_b.mT @ R_c) @ (R_a.mT @ R_b).mT) * ROT_SCALE
    r_tr = (t_c - t_b) - (t_b - t_a)
    return torch.cat([r_rot, r_tr])


def _blocks_to_dense(sel_a: torch.Tensor, blocks: torch.Tensor, sel_b: torch.Tensor):
    """sum_e sel_a[e, a] sel_b[e, b] blocks[e] as (K, 6, K, 6): the dense
    assembly of per-edge 6x6 blocks by one-hot node selectors (a product,
    so its sum order is fixed)."""
    E, K = sel_a.shape
    x = sel_b[:, :, None] * blocks.reshape(E, 1, 36)               # (E, K, 36)
    return (sel_a.T @ x.reshape(E, K * 36)).reshape(K, K, 6, 6).permute(0, 2, 1, 3)


def pose_graph_step(g: PoseGraph, *, damping: float = 1e-5) -> PoseGraph:
    """One damped Gauss-Newton step; node 0 gauge-fixed."""
    K = g.R.shape[0]
    E = g.edge_a.shape[0]
    dev, dt_ = g.t.device, g.t.dtype
    zeros = torch.zeros((E, 6), dtype=dt_, device=dev)
    (Ja, Jb), r = vmap(jacfwd(_with_value(_edge_residual_wrt_updates), argnums=(0, 1),
                              has_aux=True))(
        zeros, zeros, g.R[g.edge_a], g.t[g.edge_a], g.R[g.edge_b], g.t[g.edge_b],
        g.meas_R, g.meas_t)
    # Huber IRLS: an edge far off (a bad loop closure) is downweighted.
    r_norm = torch.sqrt(torch.sum(r * r, -1) + 1e-12)
    w = (g.weight * torch.clamp(HUBER_DELTA / r_norm, max=1.0))[:, None]
    r, Ja, Jb = r * w, Ja * w[..., None], Jb * w[..., None]

    nodes = torch.arange(K, device=dev)
    oa = (g.edge_a[:, None] == nodes[None, :]).to(dt_)
    ob = (g.edge_b[:, None] == nodes[None, :]).to(dt_)
    JaT, JbT = Ja.mT, Jb.mT
    H = (_blocks_to_dense(oa, JaT @ Ja, oa) + _blocks_to_dense(oa, JaT @ Jb, ob)
         + _blocks_to_dense(ob, JbT @ Ja, oa) + _blocks_to_dense(ob, JbT @ Jb, ob))
    b_vec = oa.T @ _matvec(JaT, r) + ob.T @ _matvec(JbT, r)        # (K, 6)

    if g.cv_w is not None:
        E3 = g.cv_w.shape[0]
        z3 = torch.zeros((E3, 6), dtype=dt_, device=dev)
        (J0, J1, J2), r_cv = vmap(jacfwd(_with_value(_cv_residual), argnums=(0, 1, 2),
                                         has_aux=True))(
            z3, z3, z3, g.R[:-2], g.t[:-2], g.R[1:-1], g.t[1:-1], g.R[2:], g.t[2:])
        J = (J0, J1, J2)
        idx = torch.arange(K - 2, device=dev)
        w_cv = g.cv_w
        for a in range(3):
            b_vec[idx + a] += torch.einsum("e,eik,ei->ek", w_cv, J[a], r_cv)
            for c in range(3):
                H[idx + a, :, idx + c, :] += torch.einsum("e,eik,eil->ekl", w_cv, J[a], J[c])

    # Gauge fix node 0.
    mask = (nodes != 0).to(dt_)
    H = H * mask[:, None, None, None] * mask[None, None, :, None]
    H[0, :, 0, :] = torch.eye(6, dtype=dt_, device=dev)
    b_vec = b_vec * mask[:, None]

    Hd = H.reshape(K * 6, K * 6)
    # Marquardt damping plus an absolute floor (disconnected nodes).
    diag = torch.diagonal(Hd)
    Hd = Hd + torch.diag(damping * diag + 1e-8 * torch.clamp(diag.max(), min=1.0))
    dx = -torch.linalg.solve_ex(Hd, b_vec.reshape(-1, 1))[0].reshape(K, 6)
    dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
    # Trust region: so3_log is valid below pi, so clamp per-node step norms.
    rot_n = torch.linalg.vector_norm(dx[:, :3], dim=1, keepdim=True)
    tr_n = torch.linalg.vector_norm(dx[:, 3:], dim=1, keepdim=True)
    max_t = 10.0 * torch.clamp(torch.abs(g.meas_t).max(), min=1.0)
    dx = torch.cat([dx[:, :3] * torch.clamp(0.5 / torch.clamp(rot_n, min=1e-12), max=1.0),
                    dx[:, 3:] * torch.clamp(max_t / torch.clamp(tr_n, min=1e-12), max=1.0)],
                   dim=1)
    dR, dt = se3_exp(dx)
    return g._replace(R=dR @ g.R, t=_matvec(dR, g.t) + dt)


def optimize_pose_graph(g: PoseGraph, *, iterations: int = 20,
                        damping: float = 1e-5) -> PoseGraph:
    for _ in range(iterations):
        g = pose_graph_step(g, damping=damping)
    return g


def graph_cost(g: PoseGraph) -> torch.Tensor:
    r = vmap(_edge_residual)(g.R[g.edge_a], g.t[g.edge_a], g.R[g.edge_b],
                             g.t[g.edge_b], g.meas_R, g.meas_t)
    return torch.sum(g.weight * torch.sum(r * r, -1))
