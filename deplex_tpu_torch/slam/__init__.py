"""Plane-landmark SLAM stack (port of ``deplex_tpu.slam``, single device).

Plane association (`association`), Gauss-Newton odometry (`odometry`),
plane-landmark bundle adjustment with Schur-complement reduction (`ba`),
pose-graph optimization (`pose_graph`), the streaming frontend
(`frontend.PlaneSlam`) and npz checkpoints (`checkpoint`). Everything runs on
the device the caller picks; per frame, extraction goes through the hand
kernels on the card.
"""

from deplex_tpu_torch.slam.association import AssociationParams, Matches, associate
from deplex_tpu_torch.slam.ba import BAProblem, BAState, ba_step, run_ba
from deplex_tpu_torch.slam.frontend import MapState, PlaneSlam, init_map
from deplex_tpu_torch.slam.odometry import OdometryResult, estimate_pose
from deplex_tpu_torch.slam.planes import (PlaneObs, from_cp, to_cp, transform_plane,
                                          untransform_plane)
from deplex_tpu_torch.slam.pose_graph import PoseGraph, graph_cost, optimize_pose_graph

__all__ = [
    "AssociationParams", "Matches", "associate",
    "BAProblem", "BAState", "ba_step", "run_ba",
    "MapState", "PlaneSlam", "init_map",
    "OdometryResult", "estimate_pose",
    "PlaneObs", "from_cp", "to_cp", "transform_plane", "untransform_plane",
    "PoseGraph", "graph_cost", "optimize_pose_graph",
]
