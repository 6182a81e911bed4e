"""Plane-SLAM frontend: extraction -> association -> odometry -> mapping.

Port of ``deplex_tpu.slam.frontend``. Per frame, stages 1-4
of the extraction pipeline (through the kernel wrappers: the hand kernels on
the card) give the merged planes; they are associated with the
plane-landmark map, the pose is refined by Gauss-Newton odometry, matched
observations are fused into the map and unmatched ones spawn landmarks. The
keyframes kept on the host form the bundle-adjustment problem (``refine``)
and the pose graph (``optimize_trajectory``), whose assembly is numpy host
code as in the reference package. On the card each frame's step
(extraction and tracking), the BA loop, the batched pose-graph edge
measurement and the pose-graph loop are each one replay of a CUDA graph
(``compiled``), as the JAX package runs each as one compiled program.

``process_frame`` opens two spans (``profiling.annotate``): ``slam.step``
around the step's replay and ``slam.download`` around the host copies and
the keyframe bookkeeping after it; and counts on the host, in
``COUNTERS``, the frames, the observations matched (read from the matches
it copies anyway) and the blocking copies to the host it made
(``profiling.slam_counters``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from deplex_tpu_torch import compiled
from deplex_tpu_torch.config import Config
from deplex_tpu_torch.pipeline import (_unbatch, compute_cells, full_float32,
                                       grow_planes, merge_planes, resolve_device)
from deplex_tpu_torch.profiling import annotate
from deplex_tpu_torch.slam.association import AssociationParams, associate
from deplex_tpu_torch.slam.odometry import estimate_pose
from deplex_tpu_torch.slam.planes import (PlaneObs, from_cp, from_segments, to_cp,
                                          untransform_plane)

# Gauss-Newton iterations of the batched pose-graph edge measurement.
PAIR_ITERATIONS = 6

# process_frame's host counts since the process started or the last
# ``profiling.reset_slam_counters``.
COUNTERS = {"slam_frames": 0, "slam_matched": 0, "slam_host_reads": 0}


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A blocking copy to the host, counted in ``slam_host_reads``."""
    COUNTERS["slam_host_reads"] += 1
    return x.cpu().numpy()


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


def init_map(max_landmarks: int, device=None) -> MapState:
    """An empty map of `max_landmarks` slots on `device` (the card by
    default; ``pipeline.resolve_device`` raises without one)."""
    dev = resolve_device(device)
    return MapState(normal=torch.zeros((max_landmarks, 3), device=dev),
                    d=torch.zeros(max_landmarks, device=dev),
                    weight=torch.zeros(max_landmarks, device=dev),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def extract_plane_obs(points: torch.Tensor, image_height: int, image_width: int,
                      config: Config) -> PlaneObs:
    """Stages 1-4 on one (H*W, 3) cloud -> the merged planes as PlaneObs.

    Stops before rasterization: SLAM needs plane parameters, not labels.
    Slots absorbed by the merge get weight 0, so each plane appears once."""
    pts = points.to(torch.float32).reshape(1, image_height, image_width, 3).contiguous()
    labels_map, segments = grow_planes(compute_cells(pts, None, config), config)
    merge_labels, merged = merge_planes(labels_map, segments, config)
    obs = from_segments(_unbatch(merged))
    keep = merge_labels[0] == torch.arange(merge_labels.shape[1], device=pts.device)
    return obs._replace(weight=torch.where(keep, obs.weight, torch.zeros_like(obs.weight)))


def slam_step(obs: PlaneObs, map_state: MapState, R_prior: torch.Tensor,
              t_prior: torch.Tensor, *, assoc: AssociationParams,
              odom_iterations: int, min_obs_weight: float):
    """The device step: associate -> pose Gauss-Newton -> fuse and spawn.
    Returns (FrameResult, the new MapState)."""
    dev = obs.d.device
    usable = obs._replace(weight=torch.where(obs.weight >= min_obs_weight, obs.weight,
                                             torch.zeros_like(obs.weight)))
    matches = associate(usable, map_state.normal, map_state.d, map_state.weight > 0,
                        R_prior, t_prior, assoc)
    odo = estimate_pose(usable, map_state.normal, map_state.d, matches.landmark,
                        matches.valid, R_prior, t_prior, iterations=odom_iterations)
    R, t = odo.R, odo.t

    # ---- fuse matched observations (weighted mean of CP vectors, world) ----
    n_w_obs, d_w_obs = untransform_plane(R, t, usable.normal, usable.d)
    M = map_state.d.shape[0]
    slots = torch.arange(M, device=dev)
    onehot = ((matches.landmark.to(torch.int64)[:, None] == slots[None, :])
              & matches.valid[:, None]).to(torch.float32)
    w_obs = onehot * usable.weight[:, None]                          # (P, M)
    add_w = w_obs.sum(0)
    cp_obs = to_cp(n_w_obs, d_w_obs)
    cp_map = to_cp(map_state.normal, map_state.d)
    tot_w = map_state.weight + add_w
    cp_new = ((cp_map * map_state.weight[:, None] + w_obs.T @ cp_obs)
              / torch.clamp(tot_w, min=1.0)[:, None])
    cp_new = torch.where((add_w > 0)[:, None], cp_new, cp_map)
    n_new, d_new = from_cp(cp_new)
    fused = MapState(normal=n_new, d=d_new,
                     weight=torch.where(add_w > 0, tot_w, map_state.weight),
                     count=map_state.count)

    # ---- spawn landmarks for unmatched observations ----
    # An unmatched observation close to ANY existing landmark must not fork
    # the map: duplicates bias later association and odometry.
    dup_cos = n_w_obs @ fused.normal.T
    dup_d = torch.abs(d_w_obs[:, None] - fused.d[None, :])
    near_dup = ((dup_cos >= assoc.dup_cos_angle) & (dup_d <= assoc.dup_offset_dist)
                & (fused.weight > 0)[None, :]).any(1)
    unmatched = (usable.weight > 0) & ~matches.valid & ~near_dup
    order = torch.cumsum(unmatched.to(torch.int32), 0) - 1          # rank per obs
    slot = fused.count + order                                       # target slots
    can = unmatched & (slot < M)
    spawn = (torch.clamp(slot, 0, M - 1)[:, None] == slots[None, :]) & can[:, None]
    spawned = spawn.any(0)
    src = torch.argmax(spawn.to(torch.int32), 0)                     # obs per slot
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


def frame_step(points: torch.Tensor, map_state: MapState, R_prior: torch.Tensor,
               t_prior: torch.Tensor, *, image_height: int, image_width: int,
               config: Config, assoc: AssociationParams, odom_iterations: int,
               min_obs_weight: float):
    """One frame, eagerly: ``extract_plane_obs`` then ``slam_step``.
    Returns (FrameResult, the new MapState)."""
    obs = extract_plane_obs(points, image_height, image_width, config)
    return slam_step(obs, map_state, R_prior, t_prior, assoc=assoc,
                     odom_iterations=odom_iterations, min_obs_weight=min_obs_weight)


class PlaneSlam:
    """Streaming plane SLAM: a host loop over frames, one device step
    per frame, on `device` (the card by default; without a card it raises
    unless `device="cpu"` asks for the plain twins).

    The step is ``_frame_fn``, the counterpart of the JAX package's jitted
    ``frame_fn``: on the card, ``frame_step`` recorded as one CUDA graph
    (``compiled``; its static inputs are the cloud, the four MapState
    tensors, R and t, refilled from ``map``, ``R`` and ``t`` before each
    replay, so ``refine``, ``optimize_trajectory`` and ``load`` may replace
    them); on the CPU, ``frame_step`` itself. The backends are the JAX
    package's compiled programs too: ``refine`` calls ``ba.run_ba`` (entry
    "run_ba"), ``optimize_trajectory`` calls ``_pair_measure_fn`` (entry
    "PlaneSlam.pair_measure_fn") and ``pose_graph.optimize_pose_graph``
    (entry "optimize_pose_graph"), with the host's candidate selection and
    edge-quality gate between them. Their keyframe, edge and node axes
    grow with the map, so each pads them to power-of-two buckets, and each
    runs eagerly at its first call and records from its second
    (``compiled``, eager_once): a run that calls a backend once pays the
    eager call alone, and a growing run replays within a bucket.
    ``refine(mesh=...)`` stays op by op (``ba.run_ba_sharded``: gloo
    collectives are staged through the host)."""

    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None, *, max_landmarks: int = 256,
                 assoc: AssociationParams | None = None,
                 odom_iterations: int = 8, min_obs_weight: float = 0.0,
                 window: int | None = None, device=None):
        self.height = int(image_height)
        self.width = int(image_width)
        self.config = config or Config()
        self.assoc = assoc or AssociationParams()
        self.odom_iterations = int(odom_iterations)
        self.min_obs_weight = float(min_obs_weight)
        self.device = resolve_device(device)
        self.map = init_map(max_landmarks, self.device)
        self.R = torch.eye(3, device=self.device)
        self.t = torch.zeros(3, device=self.device)
        self.trajectory: list[tuple[np.ndarray, np.ndarray]] = []
        self._keyframes: list = []
        # Sliding window (None = unbounded): the BA and pose-graph backends
        # see at most `window` keyframes; older poses stay in `trajectory`,
        # and tracking has fused their observations into the map.
        self.window = int(window) if window else None
        self._kf_offset = 0  # trajectory index of _keyframes[0]
        self._frame_step = functools.partial(
            frame_step, image_height=self.height, image_width=self.width, config=self.config,
            assoc=self.assoc, odom_iterations=self.odom_iterations,
            min_obs_weight=self.min_obs_weight)

    def _frame_fn(self, points, map_state, R_prior, t_prior):
        """``_frame_step`` as one CUDA graph per signature (``compiled``)."""
        static = (self.height, self.width, self.config, self.assoc, self.odom_iterations,
                  self.min_obs_weight)
        return compiled.call(
            "PlaneSlam.frame_fn",
            lambda p, n, d, w, c, R, t: self._frame_step(p, MapState(n, d, w, c), R, t),
            (points, *map_state, R_prior, t_prior), static)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def process_frame(self, points) -> FrameResult:
        """points: an (H*W, 3) organized cloud (numpy or tensor)."""
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        with full_float32(self.device), annotate("slam.step"):
            result, self.map = self._frame_fn(pts, self.map, self.R, self.t)
        self.R, self.t = result.R, result.t
        with annotate("slam.download"):
            self.trajectory.append((_to_host(self.R), _to_host(self.t)))
            keyframe = tuple(_to_host(x) for x in (result.obs.normal, result.obs.d,
                                                   result.obs.weight, result.matches_lm))
            self._keyframes.append(keyframe)
            if self.window is not None and len(self._keyframes) > self.window:
                del self._keyframes[: len(self._keyframes) - self.window]
                self._kf_offset = len(self.trajectory) - len(self._keyframes)
        COUNTERS["slam_frames"] += 1
        COUNTERS["slam_matched"] += int((keyframe[3] >= 0).sum())
        return result

    @property
    def _window_traj(self):
        """The trajectory slice the retained keyframes correspond to."""
        return self.trajectory[self._kf_offset:]

    def build_ba_problem(self, odo_weight: float = 3.0, cv_weight: float = 10000.0,
                         edge_cos_gate: float = 0.95, edge_offset_gate: float = 300.0):
        """The keyframes as a BAProblem on the device: observations matched
        during tracking, re-checked against the current map (gross outliers
        dropped; landmarks seen in fewer than two keyframes dropped), initial
        landmarks from the map, and, when the weights are > 0, odometry and
        constant-velocity priors from the tracked trajectory."""
        from deplex_tpu_torch.slam.ba import BAProblem

        K = len(self._keyframes)
        obs_normal = np.stack([k[0] for k in self._keyframes])
        obs_d = np.stack([k[1] for k in self._keyframes])
        w = np.stack([k[2] for k in self._keyframes])
        lm = np.stack([k[3] for k in self._keyframes])
        # Support-weighted observations (sqrt, as odometry).
        obs_w = np.where((lm >= 0) & (w > 0),
                         np.sqrt(np.maximum(w, 0.0)), 0.0).astype(np.float32)
        # BA edge gate: a match the loose tracking gate admitted would be a
        # permanent wrong factor here; re-check it at the tracked pose.
        R_all = np.stack([p[0] for p in self._window_traj])
        t_all = np.stack([p[1] for p in self._window_traj])
        n_map = self.map.normal.cpu().numpy()
        d_map = self.map.d.cpu().numpy()
        lm_c = np.maximum(lm, 0)
        n_pred = np.einsum("kij,kpj->kpi", R_all, n_map[lm_c])       # (K, P, 3)
        d_pred = d_map[lm_c] - np.einsum("kpi,ki->kp", n_pred, t_all)
        cosang = np.einsum("kpi,kpi->kp", obs_normal, n_pred)
        edge_ok = (cosang >= edge_cos_gate) & (np.abs(obs_d - d_pred) <= edge_offset_gate)
        obs_w = np.where(edge_ok, obs_w, 0.0).astype(np.float32)
        M = int(self.map.d.shape[0])
        seen = np.bincount(lm[(lm >= 0) & (obs_w > 0)].ravel(), minlength=M)
        obs_w = np.where(seen[np.maximum(lm, 0)] >= 2, obs_w, 0.0)
        if (obs_w > 0).any():
            obs_w = obs_w / obs_w[obs_w > 0].mean()
        eta = to_cp(self.map.normal, self.map.d)
        priors = {}
        if odo_weight > 0.0 and K >= 2:
            odo_R = np.einsum("kij,klj->kil", R_all[:-1], R_all[1:])    # R_i R_{i+1}^T
            odo_t = t_all[:-1] - np.einsum("kij,kj->ki", odo_R, t_all[1:])
            priors = {"odo_R": self._tensor(odo_R), "odo_t": self._tensor(odo_t),
                      "odo_w": torch.full((K - 1,), odo_weight, device=self.device)}
        if cv_weight > 0.0 and K >= 3:
            priors["cv_w"] = torch.full((K - 2,), cv_weight, device=self.device)
        return BAProblem(R=self._tensor(R_all), t=self._tensor(t_all), eta=eta,
                         obs_normal=self._tensor(obs_normal), obs_d=self._tensor(obs_d),
                         obs_lm=self._tensor(np.maximum(lm, 0), torch.int64),
                         obs_w=self._tensor(obs_w), **priors)

    def _pair_inputs(self, pairs):
        """The batched edge measurement's inputs for `pairs` ((a, b) keyframe
        indices): frame a's observations, frame b's as the "world" landmarks,
        match[e, i] = the first j with l_b[j] == l_a[i] (else -1), and the
        tracked relative pose as the start. The edge axis is padded to
        max(8, the next power of two) as the JAX package pads it, so that a
        few graphs serve every edge count: a padded edge observes nothing
        (zero weight, match -1) from R0 = I, t0 = 0."""
        P = self._keyframes[0][0].shape[0]
        A = np.asarray([p[0] for p in pairs])
        B = np.asarray([p[1] for p in pairs])
        n_kf, d_kf, w_kf, l_kf = (np.stack([kf[i] for kf in self._keyframes])
                                  for i in range(4))
        la, lb = l_kf[A], l_kf[B]
        eq = (la[:, :, None] == lb[:, None, :]) & (la >= 0)[:, :, None]
        has = eq.any(-1)
        match = np.where(has, eq.argmax(-1), -1)
        Rs = np.stack([R for R, _ in self._window_traj])
        ts = np.stack([t for _, t in self._window_traj])
        R0 = np.einsum("eij,ekj->eik", Rs[A], Rs[B])            # Ra @ Rb^T
        t0 = ts[A] - np.einsum("eij,ej->ei", R0, ts[B])
        E = len(pairs)
        Epad = compiled.bucket(E)

        def pad(x, fill=0):
            return np.concatenate([x, np.full((Epad - E, *x.shape[1:]), fill, x.dtype)])

        eye = np.broadcast_to(np.eye(3, dtype=R0.dtype), (Epad - E, 3, 3))
        obs = PlaneObs(normal=self._tensor(pad(n_kf[A])), d=self._tensor(pad(d_kf[A])),
                       weight=self._tensor(pad(w_kf[A])),
                       mean=torch.zeros((Epad, P, 3), device=self.device))
        return (obs, self._tensor(pad(n_kf[B])), self._tensor(pad(d_kf[B])),
                self._tensor(pad(match, -1), torch.int64), self._tensor(pad(has), torch.bool),
                self._tensor(np.concatenate([R0, eye])), self._tensor(pad(t0)))

    def _pair_measure_fn(self, obs: PlaneObs, lm_normal, lm_d, match, has, R0, t0):
        """``estimate_pose`` (6 iterations) over the leading edge axis, the
        counterpart of the JAX package's jitted vmap: one CUDA graph per
        padded edge count on the card (``compiled``, eager_once)."""
        return compiled.call(
            "PlaneSlam.pair_measure_fn",
            lambda n, d, w, m, *rest: estimate_pose(PlaneObs(n, d, w, m), *rest,
                                                    iterations=PAIR_ITERATIONS),
            (*obs, lm_normal, lm_d, match, has, R0, t0), (PAIR_ITERATIONS,), eager_once=True)

    def build_pose_graph(self, min_shared: int = 3, tracking_prior_weight: float = 1.0,
                         cv_weight: float = 10000.0):
        """Pose graph over the keyframes (world-from-camera nodes): edges
        between every pair that co-observes >= min_shared landmarks, each
        measured directly from the shared planes by one batched Gauss-Newton
        over all candidate pairs; loop closures far off the consecutive
        edges' residual dropped; edges weighted by their shared-plane count;
        plus consecutive priors from the tracked trajectory
        (tracking_prior_weight > 0) and constant-velocity priors."""
        from deplex_tpu_torch.slam.pose_graph import PoseGraph

        K = len(self._keyframes)
        l_kf = np.stack([kf[3] for kf in self._keyframes])     # (K, P) int

        # Candidate pairs from the co-observation counts: consecutive edges
        # first, then loop closures (b >= a + 2).
        M = int(self.map.d.shape[0])
        occ = np.zeros((K, M), np.int32)
        kk, pp = np.nonzero(l_kf >= 0)
        occ[kk, l_kf[kk, pp]] = 1
        shared = occ @ occ.T
        pairs = [(a, a + 1) for a in range(K - 1) if shared[a, a + 1] >= min_shared]
        iu, ju = np.triu_indices(K, k=2)
        pairs += [(int(a), int(b)) for a, b in zip(iu, ju) if shared[a, b] >= min_shared]
        if not pairs:
            raise ValueError("no pose-graph edges (no co-observed planes)")

        A = np.asarray([p[0] for p in pairs])
        B = np.asarray([p[1] for p in pairs])
        E = len(pairs)
        res = self._pair_measure_fn(*self._pair_inputs(pairs))
        meas_R = res.R[:E].cpu().numpy()
        meas_t = res.t[:E].cpu().numpy()

        # Edge-quality gate: a loop closure whose per-plane residual is far
        # above the consecutive edges' is a misassociation or degenerate
        # geometry. Consecutive edges are all kept (connectivity).
        per = res.residual[:E].cpu().numpy() / np.maximum(res.num_inliers[:E].cpu().numpy(), 1)
        consec = (B - A) == 1
        anchor = np.median(per[consec]) if consec.any() else np.median(per)
        keep = consec | (per <= 5.0 * max(float(anchor), 1e-9))
        A, B = A[keep], B[keep]
        meas_R, meas_t = meas_R[keep], meas_t[keep]
        # Information-proportional weights: the co-observed plane count,
        # normalized so that a typical consecutive edge weighs 1.
        n_shared = np.asarray([shared[a, b] for a, b in zip(A, B)], np.float32)
        consec_k = (B - A) == 1
        norm = np.median(n_shared[consec_k]) if consec_k.any() else max(n_shared.max(), 1.0)
        w_edges = n_shared / max(float(norm), 1.0)

        # World-from-camera nodes, so edges compose as T_ab = T_wc(a)^-1 T_wc(b).
        R_wc = np.stack([R.T for R, _ in self._window_traj])
        t_wc = np.stack([-R.T @ t for R, t in self._window_traj])
        if tracking_prior_weight > 0.0 and K >= 2:
            Ap = np.arange(K - 1)
            Bp = Ap + 1
            pR = np.einsum("kji,kjl->kil", R_wc[Ap], R_wc[Bp])   # Ra^T Rb
            pt = np.einsum("kji,kj->ki", R_wc[Ap], t_wc[Bp] - t_wc[Ap])
            A = np.concatenate([A, Ap])
            B = np.concatenate([B, Bp])
            meas_R = np.concatenate([meas_R, pR.astype(np.float32)])
            meas_t = np.concatenate([meas_t, pt.astype(np.float32)])
            w_edges = np.concatenate([w_edges, np.full(K - 1, tracking_prior_weight,
                                                       np.float32)])
        return PoseGraph(
            R=self._tensor(R_wc), t=self._tensor(t_wc),
            edge_a=self._tensor(A, torch.int64), edge_b=self._tensor(B, torch.int64),
            meas_R=self._tensor(meas_R), meas_t=self._tensor(meas_t),
            weight=self._tensor(w_edges),
            cv_w=(torch.full((K - 2,), cv_weight, device=self.device)
                  if cv_weight > 0.0 and K >= 3 else None))

    def optimize_trajectory(self, iterations: int = 15, min_shared: int = 3,
                            tracking_prior_weight: float = 1.0, cv_weight: float = 10000.0):
        """Pose-graph optimization of the keyframe trajectory (in place)."""
        from deplex_tpu_torch.slam.pose_graph import optimize_pose_graph

        with full_float32(self.device):
            g = self.build_pose_graph(min_shared=min_shared,
                                      tracking_prior_weight=tracking_prior_weight,
                                      cv_weight=cv_weight)
            out = optimize_pose_graph(g, iterations=iterations)
        R_wc = out.R.cpu().numpy()
        t_wc = out.t.cpu().numpy()
        self.trajectory[self._kf_offset:] = [
            (R_wc[i].T, -R_wc[i].T @ t_wc[i]) for i in range(R_wc.shape[0])]
        self._set_pose_from_trajectory()
        return out

    def _set_pose_from_trajectory(self) -> None:
        self.R = self._tensor(self.trajectory[-1][0])
        self.t = self._tensor(self.trajectory[-1][1])

    def save(self, path: str) -> None:
        """Snapshot the whole tracker state (map, pose, trajectory, keyframe
        observations) to path.npz; resume with load()."""
        from deplex_tpu_torch.slam.checkpoint import save_checkpoint

        if not self._keyframes:
            raise ValueError("nothing to checkpoint: no frames processed")
        save_checkpoint(path, self._snapshot_state())

    def load(self, path: str) -> None:
        """Restore a snapshot written by save() (of this package or of the
        reference package's npz form); tracking continues where it stopped."""
        from deplex_tpu_torch.slam.checkpoint import load_checkpoint

        example = self._snapshot_state() if self._keyframes else self._snapshot_example()
        state = load_checkpoint(path, example)
        self.map = MapState(*(torch.as_tensor(x, device=self.device) for x in state["map"]))
        self.R = self._tensor(state["R"])
        self.t = self._tensor(state["t"])
        K = state["traj_R"].shape[0]
        self.trajectory = [(np.asarray(state["traj_R"][i]), np.asarray(state["traj_t"][i]))
                           for i in range(K)]
        Kk = state["kf_normal"].shape[0]     # < K when a window was active
        self._keyframes = [tuple(np.asarray(state[f"kf_{n}"][i])
                                 for n in ("normal", "d", "weight", "lm"))
                           for i in range(Kk)]
        self._kf_offset = K - Kk

    def _snapshot_state(self) -> dict:
        return {
            "map": MapState(*(x.cpu().numpy() for x in self.map)),
            "R": self.R.cpu().numpy(), "t": self.t.cpu().numpy(),
            "traj_R": np.stack([R for R, _ in self.trajectory]),
            "traj_t": np.stack([t for _, t in self.trajectory]),
            "kf_normal": np.stack([k[0] for k in self._keyframes]),
            "kf_d": np.stack([k[1] for k in self._keyframes]),
            "kf_weight": np.stack([k[2] for k in self._keyframes]),
            "kf_lm": np.stack([k[3] for k in self._keyframes]),
        }

    def _snapshot_example(self) -> dict:
        """Zero-frame example tree (same structure) for load-before-track."""
        P = int(self.config.max_planes)
        return {
            "map": MapState(*(x.cpu().numpy() for x in self.map)),
            "R": np.zeros((3, 3), np.float32), "t": np.zeros(3, np.float32),
            "traj_R": np.zeros((0, 3, 3), np.float32),
            "traj_t": np.zeros((0, 3), np.float32),
            "kf_normal": np.zeros((0, P, 3), np.float32),
            "kf_d": np.zeros((0, P), np.float32),
            "kf_weight": np.zeros((0, P), np.float32),
            "kf_lm": np.zeros((0, P), np.int32),
        }

    def refine(self, iterations: int = 10, damping: float = 1e-4,
               odo_weight: float = 3.0, cv_weight: float = 10000.0, mesh=None):
        """Bundle adjustment over the keyframes (Levenberg-Marquardt on this
        slam's device); updates the trajectory and the map.

        mesh: a DeviceMesh shards the keyframe axis over its 'kf' ranks
        (``ba.run_ba_sharded``; every rank calls refine on the same state
        and ends with the same result; op by op, as its gloo collectives
        are staged through the host, which a CUDA graph cannot record).
        None: sharded over the initialized world when it has more than one
        rank, else dense. False: dense (``ba.run_ba``: one CUDA graph on a
        card)."""
        from deplex_tpu_torch.parallel.distributed import world_size
        from deplex_tpu_torch.slam.ba import run_ba, run_ba_sharded

        with full_float32(self.device):
            problem = self.build_ba_problem(odo_weight=odo_weight, cv_weight=cv_weight)
            if mesh is not False and (mesh is not None or world_size() > 1):
                out = run_ba_sharded(problem, mesh, iterations=iterations, damping=damping)
            else:
                out = run_ba(problem, iterations=iterations, damping=damping)
        R, t = out.R.cpu().numpy(), out.t.cpu().numpy()
        self.trajectory[self._kf_offset:] = [(R[i], t[i]) for i in range(R.shape[0])]
        n, d = from_cp(out.eta)
        self.map = self.map._replace(normal=n, d=d)
        self._set_pose_from_trajectory()
        return out
