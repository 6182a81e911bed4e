"""The plane-SLAM judge: the sessions the window's own calls tracked, a
seeded sample of whole sessions, against the plain reference
(``benchmark.reference.slam``), after the window on the same device, in
float32 with TF32 off. Every frame of every judged session is compared, in
two parts.

**The planes** (stages 1-4): each frame's observations (``FrameResult.obs``)
against the reference's stages 1-4 on the same frame, once a distinct
sequence:

- ``plane_slots_mismatched`` (at most 0): the slots occupied (weight > 0)
  in one and not in the other, plus the slots whose weight differs. A
  weight is a plane's point count, a sum of whole numbers that float32
  holds exactly in any order, so it is exact.
- ``normal_err_max``, ``offset_err_mm_max`` and ``mean_err_mm_max``, at most
  ``NORMAL_LIMIT``, ``OFFSET_LIMIT_MM`` and ``MEAN_LIMIT_MM``: the largest
  difference of a normal's component, an offset and a mean's coordinate
  over the slots both occupy. The card's merge (K3) refits the merged
  planes with its own sums and eigen-solve, so these are rounding, not 0.

**The step** (association, odometry, fusion and spawning): the reference's
step fed the program's own observations, frame by frame from an empty map
and the identity pose, against the program's results:

- ``mismatched_matches`` (at most 0): the observation slots whose matched
  landmark (``matches_lm``) differs, plus one for a frame whose
  ``num_matched`` differs and one for a frame whose ``num_new`` differs.
- ``rot_err_max`` (rad) and ``trans_err_mm_max`` (mm), at most
  ``ROT_LIMIT_RAD`` and ``TRANS_LIMIT_MM``: the largest angle of
  R_program^T R_reference and the largest distance between the two
  translations, in float64.
- ``map_count_mismatched`` (at most 0): the judged sessions whose map holds
  another number of landmarks at the session's end.
- ``frames_judged`` (at least one whole session, ``episode_frames``).

The step is fed the program's planes, not the reference's, because the
association's gates and argmin are discrete: a plane rounded otherwise can
flip a match, and one flipped match moves the pose by tens of mm for the
rest of the session (the reference's own step on its planes with 1e-6
relative noise: one flip in four 30-frame sessions, 0.72 mrad and 29 mm).
Fed the same planes, the step is the same float32 operations, and any
difference is a fault.

``failed`` counts the judged frames with a slot, a plane, a match, a count
or a pose outside these limits. The control's stand-in puts the
reference's stages 1-4 and step, in TF32, in the place of
``PlaneSlam.process_frame``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.judge import Verdict
from benchmark.reference import precision, slam
from benchmark.reference.stages import backproject, full_float32

# The limits, set from the H100's sound runs and the TF32 control on it.
# A normal: chip_smoke.py's tolerance of the card's merge against its plain
# twin, 1e-4 (sound runs read at most 1.2e-6, the control 1.68). An offset
# and a mean's coordinate: 0.1 mm, 17x the sound runs' largest reading
# (0.0059 mm, a dozen float32 ulps at the frame's depths; means read 0) and
# five orders below the control's (8,527 mm and more).
NORMAL_LIMIT = 1e-4
OFFSET_LIMIT_MM = 0.1
MEAN_LIMIT_MM = 0.1
# The step fed the program's planes reads 0 rad and 0 mm on the card (the
# same float32 operations on the same inputs), so its limits are the floors
# that tests/test_torch_compiled.py holds the step fed its state to; the
# control misses them by 0.008 rad and 256 mm and more.
ROT_LIMIT_RAD = 1e-5
TRANS_LIMIT_MM = 0.05


def _planes(cell, depth: list, device) -> list:
    """The reference's stages 1-4 on one sequence's uint16 host frames."""
    frames = torch.from_numpy(np.stack(depth).view(np.int16)).to(device).view(torch.uint16)
    K = torch.as_tensor(cell.intrinsics, device=device)
    N, H, W = frames.shape
    with full_float32():
        return slam.plane_obs(backproject(frames, K), H, W, cell.reference_config())


def _steps(cell, results: list, device) -> tuple:
    """The reference's step over the program's observations of one session,
    from an empty map and the identity pose: ([FrameResult], the MapState)."""
    s = cell.config["slam"]
    state = slam.init_map(int(s["max_landmarks"]), device)
    R, t = torch.eye(3, device=device), torch.zeros(3, device=device)
    out = []
    with full_float32():
        for got in results:
            obs = slam.PlaneObs(*(x.to(device) for x in got.obs))
            res, state = slam.slam_step(obs, state, R, t, assoc=slam.AssociationParams(),
                                        odom_iterations=int(s["odom_iterations"]),
                                        min_obs_weight=float(s["min_obs_weight"]))
            R, t = res.R, res.t
            out.append(res)
    return out, state


def rotation_error(R: torch.Tensor, R_ref: torch.Tensor) -> float:
    """The angle of R^T R_ref in radians, in float64 (atan2 of the skew
    part's norm over the trace's: accurate near 0, where acos is not)."""
    D = R.double().transpose(-1, -2) @ R_ref.double()
    w = torch.stack([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    angle = torch.atan2(torch.linalg.vector_norm(w) / 2, (torch.trace(D) - 1) / 2)
    return float(torch.nan_to_num(angle, nan=float("inf")))


def _largest(diff: torch.Tensor) -> float:
    """The largest |diff|, NaN as infinity, 0 when empty."""
    return float(torch.nan_to_num(diff.abs(), nan=float("inf")).max()) if diff.numel() else 0.0


def plane_errors(got, want) -> tuple:
    """(slots mismatched, normal, offset and mean errors) of one frame's
    observations against the reference's."""
    w = got.weight.to(want.weight.device)
    occupied, ref_occupied = w > 0, want.weight > 0
    slots = int((occupied != ref_occupied).sum() + ((w != want.weight) & occupied
                                                    & ref_occupied).sum())
    both = occupied & ref_occupied
    return (slots, _largest(got.normal.to(both.device)[both] - want.normal[both]),
            _largest(got.d.to(both.device)[both] - want.d[both]),
            _largest(got.mean.to(both.device)[both] - want.mean[both]))


def judge(samples: list, cell, device: torch.device, records: bool = False) -> Verdict:
    """samples: (sequence key, its uint16 host frames, the FrameResults the
    program returned for them, the program's map count at the session's
    end) of each judged session."""
    planes = {}
    frames = mismatched = slots = failed = counts_off = 0
    err = dict(normal=0.0, offset=0.0, mean=0.0, rot=0.0, trans=0.0)
    for key, depth, results, count in samples:
        if key not in planes:
            planes[key] = _planes(cell, depth, device)
        steps, state = _steps(cell, results, device)
        mismatched += len(planes[key]) - min(len(results), len(planes[key]))
        for got, want, step in zip(results, planes[key], steps):
            s, normal, offset, mean = plane_errors(got.obs, want)
            m = int((got.matches_lm.to(device) != step.matches_lm).sum())
            m += int(int(got.num_matched) != int(step.num_matched))
            m += int(int(got.num_new) != int(step.num_new))
            rot = rotation_error(got.R.to(device), step.R)
            trans = float(torch.nan_to_num(torch.linalg.vector_norm(
                got.t.to(device).double() - step.t.double()), nan=float("inf")))
            for name, v in zip(err, (normal, offset, mean, rot, trans)):
                err[name] = max(err[name], v)
            slots += s
            mismatched += m
            failed += int(s > 0 or normal > NORMAL_LIMIT or offset > OFFSET_LIMIT_MM
                          or mean > MEAN_LIMIT_MM or m > 0 or rot > ROT_LIMIT_RAD
                          or trans > TRANS_LIMIT_MM)
            frames += 1
        counts_off += int(int(count) != int(state.count))
    least = int(cell.config["slam"]["episode_frames"])
    at_most = lambda value, limit: {"value": value, "limit": limit, "rule": "at most"}  # noqa: E731
    compared = {"frames_judged": {"value": frames, "limit": least, "rule": "at least"},
                "plane_slots_mismatched": at_most(slots, 0),
                "normal_err_max": at_most(err["normal"], NORMAL_LIMIT),
                "offset_err_mm_max": at_most(err["offset"], OFFSET_LIMIT_MM),
                "mean_err_mm_max": at_most(err["mean"], MEAN_LIMIT_MM),
                "mismatched_matches": at_most(mismatched, 0),
                "rot_err_max": at_most(err["rot"], ROT_LIMIT_RAD),
                "trans_err_mm_max": at_most(err["trans"], TRANS_LIMIT_MM),
                "map_count_mismatched": at_most(counts_off, 0)}
    correct = frames >= least and all(c["value"] <= c["limit"] for name, c in compared.items()
                                      if c["rule"] == "at most")
    return Verdict(correct, failed, compared)


@contextlib.contextmanager
def in_place_of_program(cell, device):
    """``PlaneSlam.process_frame`` replaced by the reference's stages 1-4
    and step in TF32 on the tracker's own state, with the method's return
    value and host side effects (the pose, the map, the trajectory and the
    keyframe on the host)."""
    from deplex_tpu_torch.slam import frontend

    config = cell.reference_config()

    def process_frame(self, points):
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        with precision.tf32(), full_float32():
            [obs] = slam.plane_obs(pts[None], self.height, self.width, config)
            res, state = slam.slam_step(obs, slam.MapState(*self.map), self.R, self.t,
                                        assoc=slam.AssociationParams(*self.assoc),
                                        odom_iterations=self.odom_iterations,
                                        min_obs_weight=self.min_obs_weight)
        self.map = frontend.MapState(*state)
        self.R, self.t = res.R, res.t
        self.trajectory.append((res.R.cpu().numpy(), res.t.cpu().numpy()))
        self._keyframes.append(tuple(x.cpu().numpy() for x in (
            res.obs.normal, res.obs.d, res.obs.weight, res.matches_lm)))
        return frontend.FrameResult(res.R, res.t, res.num_matched, res.num_new,
                                    frontend.PlaneObs(*res.obs), res.matches_lm)

    saved = frontend.PlaneSlam.process_frame
    frontend.PlaneSlam.process_frame = process_frame
    try:
        yield
    finally:
        frontend.PlaneSlam.process_frame = saved
