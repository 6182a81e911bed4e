"""Plane-SLAM demo: track camera poses through a depth sequence.

Port of the reference package's ``examples/python/run_slam.py``. With
``--dataset DIR`` (a directory of depth PNGs, e.g. from
``deplex_tpu_torch.tools.make_sequence``): the native ``SequenceLoader`` ->
``pipeline.backproject_device`` -> ``PlaneSlam.process_frame``; then bundle
adjustment and the pose graph, each applied to the tracked state on its
own, ATE of each against ``trajectory_gt.npz`` when the directory has one,
and a JSON report (the protocol of ``data/golden/slam_ate_tum30.json``).
Without it, a synthetic box room seen from a moving camera.

    python -m deplex_tpu_torch.examples.run_slam --dataset /tmp/tum_seq \\
        --config data/configs/TUM_fr3_long_val.ini --max-landmarks 128 --frames 30
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]

PROTOCOL = ("run_slam.py --dataset: native SequenceLoader -> PlaneSlam tracking; BA "
            "(odometry + constant-velocity motion priors, slam/ba.py) and pose-graph "
            "(info-weighted edges + tracking priors + cv priors, slam/pose_graph.py) each "
            "applied to the tracked trajectory independently; sequence from "
            "scripts/make_sequence.py (warped real frame, exact ground truth)")


def synthetic_sequence(n_frames, H, W, K, rng):
    """Depth frames of a 4m x 4m x 3m box room from a moving camera, and the
    camera-from-world poses."""
    from deplex_tpu_torch.utils.warp import _rodrigues

    fx, cx = K[0, 0], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    u = (np.arange(W, dtype=np.float32) - cx) / fx
    v = (np.arange(H, dtype=np.float32) - cy) / fy
    rays = np.stack([np.tile(u, (H, 1)), np.tile(v[:, None], (1, W)),
                     np.ones((H, W), np.float32)], axis=-1)   # camera rays, z=1
    # Room: 6 planes n.x + d = 0 (mm), camera starts at the center.
    planes_n = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], np.float32)
    planes_d = np.array([2000, 2000, 1500, 1500, 2000, 4000], np.float32)
    # Look toward a room corner so three walls are visible at moderate angles.
    R_wc = _rodrigues(np.array([-0.5, 0.5, 0.0], np.float32))
    t_wc = np.zeros(3, np.float32)
    frames, poses = [], []
    for _ in range(n_frames):
        R_cw = R_wc.T
        poses.append((R_cw, -R_cw @ t_wc))
        # Ray-cast: for each pixel, the nearest positive depth over the planes.
        denom = (rays @ R_wc.T) @ planes_n.T                  # (H, W, 6)
        numer = -(t_wc @ planes_n.T + planes_d)
        z = numer[None, None, :] / np.where(np.abs(denom) > 1e-6, denom, 1e-6)
        z = np.where((denom < -1e-6) & (z > 100), z, np.inf).min(axis=-1)
        frames.append(np.where(np.isfinite(z), z, 0.0).astype(np.float32))
        R_wc = _rodrigues((rng.normal(size=3) * 0.004).astype(np.float32)) @ R_wc
        t_wc = t_wc + R_wc @ np.array([15.0, 5.0, 25.0], np.float32)
    return frames, poses


def ate_mm(trajectory, gt_R, gt_t) -> float:
    """RMS distance of camera centers (c = -R^T t), mm, rounded as reported."""
    errs = [np.linalg.norm(-R.T @ t - (-gt_R[i].T @ gt_t[i]))
            for i, (R, t) in enumerate(trajectory)]
    return round(float(np.sqrt(np.mean(np.square(errs)))), 3)


def run_dataset(args):
    """Track the PNG sequence of args.dataset; returns (report, the tracked
    [(R, t)] camera-from-world poses, per-frame (matched, new))."""
    import torch

    from deplex_tpu_torch import Config, PlaneSlam
    from deplex_tpu_torch.native import SequenceLoader
    from deplex_tpu_torch.pipeline import backproject_device, depth_tensor
    from deplex_tpu_torch.utils import read_intrinsics
    from deplex_tpu_torch.utils.depth_image import png16_shape

    root = pathlib.Path(args.dataset)
    paths = sorted(root.glob("*.png"))
    if args.frames > 0:
        paths = paths[:args.frames]
    if not paths:
        raise SystemExit(f"no *.png frames in {root}")
    H, W = png16_shape(paths[0])
    K = torch.as_tensor(read_intrinsics(args.intrinsics))
    cfg = Config.from_ini(args.config) if args.config else Config()

    slam = PlaneSlam(H, W, cfg, max_landmarks=args.max_landmarks, odom_iterations=10,
                     window=args.window or None, device=args.device)
    loader = SequenceLoader([str(p) for p in paths], W, H)
    counts = []
    try:
        for n, depth in enumerate(loader):
            res = slam.process_frame(backproject_device(depth_tensor(depth, slam.device), K))
            counts.append((int(res.num_matched), int(res.num_new)))
            if n % 10 == 0:
                print(f"frame {n:4d}: matched={counts[-1][0]:2d} new={counts[-1][1]:2d}")
    finally:
        loader.close()

    gt_file = root / "trajectory_gt.npz"
    gt = dict(np.load(gt_file)) if gt_file.exists() else None

    def ate(traj):
        return None if gt is None else ate_mm(traj, gt["R"], gt["t"])

    traj_len = None
    if gt is not None:
        centers = np.einsum("kij,kj->ki", gt["R"].transpose(0, 2, 1), -gt["t"])
        traj_len = round(float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum()), 1)
    manifest = root / "manifest.json"
    report = {"dataset": str(root), "frames": len(counts), "protocol": PROTOCOL,
              "trajectory_length_mm": traj_len, "window": args.window or None,
              "args": {"frames": args.frames, "config": args.config,
                       "intrinsics": args.intrinsics, "max_landmarks": args.max_landmarks},
              "sequence_manifest": (json.loads(manifest.read_text())
                                    if manifest.exists() else None),
              "landmarks": int(slam.map.count),
              "ate_rmse_mm": {"tracking": ate(slam.trajectory)}}
    # Each backend starts from the tracked state: chaining them would start
    # BA from poses the pose graph moved away from the map it refines.
    tracked, tracked_map = list(slam.trajectory), slam.map
    slam.refine(iterations=10)
    report["ate_rmse_mm"]["ba"] = ate(slam.trajectory)
    slam.trajectory, slam.map = list(tracked), tracked_map
    try:
        slam.optimize_trajectory(min_shared=args.min_shared)
        report["ate_rmse_mm"]["pose_graph"] = ate(slam.trajectory)
    except ValueError as e:
        report["pose_graph_skipped"] = str(e)
    print(json.dumps(report))
    if args.report:
        out = pathlib.Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2) + "\n")
    return report, tracked, counts


def run_synthetic(args) -> None:
    import torch

    from deplex_tpu_torch import Config, PlaneSlam
    from deplex_tpu_torch.pipeline import backproject_device

    H, W = (int(x) for x in args.size.split("x"))
    K = np.array([[160.0, 0, W / 2 - 0.5], [0, 160.0, H / 2 - 0.5], [0, 0, 1]], np.float32)
    frames, gt = synthetic_sequence(args.frames, H, W, K, np.random.default_rng(0))
    cfg = Config(patch_size=8, max_planes=16, max_region_growing_rounds=32,
                 min_region_growing_cells_activated=3, min_region_growing_candidate_size=3,
                 # Oblique synthetic walls: adjacent-pixel depth steps exceed
                 # the TUM-tuned 160 mm default.
                 depth_discontinuity_threshold=600.0, min_cos_angle_merge=0.97)
    slam = PlaneSlam(H, W, cfg, max_landmarks=32, device=args.device)
    Kt = torch.from_numpy(K)
    errs = []
    for i, depth in enumerate(frames):
        res = slam.process_frame(backproject_device(torch.from_numpy(depth).to(slam.device), Kt))
        R_est, t_est = res.R.cpu().numpy(), res.t.cpu().numpy()
        R_gt, t_gt = gt[i]
        errs.append(np.linalg.norm(-R_est.T @ t_est - (-R_gt.T @ t_gt)))
        print(f"frame {i:3d}: matched={int(res.num_matched):2d} "
              f"new={int(res.num_new):2d} ate={errs[-1]:8.2f}mm")
    ate = float(np.sqrt(np.mean(np.square(errs))))
    print(f"RMS ATE (odometry): {ate:.2f} mm over {len(frames)} frames "
          f"({int(slam.map.count)} landmarks)")
    slam.refine(iterations=10)
    gt_R = np.stack([R for R, _ in gt])
    gt_t = np.stack([t for _, t in gt])
    print(f"RMS ATE (after BA): {ate_mm(slam.trajectory, gt_R, gt_t):.2f} mm")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--size", default="120x160", help="HxW for the synthetic sequence")
    parser.add_argument("--dataset", default=None,
                        help="directory of depth PNGs (e.g. from "
                             "deplex_tpu_torch.tools.make_sequence); default: synthetic")
    parser.add_argument("--intrinsics", default=str(ROOT / "data/configs/TUM_fr3_long_val.K"))
    parser.add_argument("--config", default=None, help="algorithm .ini")
    parser.add_argument("--max-landmarks", type=int, default=64)
    parser.add_argument("--window", type=int, default=0,
                        help="sliding keyframe window for the BA/pose-graph backends "
                             "(0 = unbounded)")
    parser.add_argument("--min-shared", type=int, default=3)
    parser.add_argument("--report", default=None, help="write the ATE report JSON here")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dataset:
        run_dataset(args)
    else:
        run_synthetic(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
