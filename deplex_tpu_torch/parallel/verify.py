"""Distributed bring-up worker: the package's multi-rank paths end to end.

One process of a group started by ``parallel.launcher`` (or torchrun). It
runs
  1. extraction split over the 'data' ranks: its own frames through
     ``extract_depth_batch`` (no collective on that path), and the whole
     batch's clouds through ``ShardedPlaneExtractor`` (labels gathered);
  2. one keyframe-sharded ``ba_step`` and ``run_ba_sharded`` (the LM loop)
     over a 'kf' mesh;
  3. with ``--slam-checkpoint``, ``PlaneSlam.refine(mesh=...)`` from a saved
     tracker state;
or, with ``--spatial``, only ``parallel.spatial.extract_planes_spatial`` on
one frame over a 'space' mesh; and writes this rank's results, kernel
launch counts and times to
``--out/proc<rank>.npz``, for a supervisor to hold against one process
(tests/test_torch_parallel.py, chip_smoke.py).

Inputs are built in (no JAX) or read from files, so that a supervisor can
feed the reference package's own arrays:
  --depth NPZ            depth (B, H, W) uint16, K (3, 3), config (JSON of
                         the Config fields)
  --ba-problem NPZ       BAProblem fields (optional prior fields may be absent)
  --slam-checkpoint PATH PATH.npz written by PlaneSlam.save, PATH.json the
                         PlaneSlam arguments (write_slam_job)
  --spatial NPZ          points (H*W, 3) float32, height, width, config
                         (JSON of the Config fields): the spatial mode

Usage (two CPU ranks):

    python -m deplex_tpu_torch.parallel.launcher --nprocs 2 --device cpu -- \\
        python -m deplex_tpu_torch.parallel.verify --out /tmp/v
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

VERIFY_H, VERIFY_W = 48, 64
VERIFY_BA_LANDMARKS = 10
FRAMES_PER_RANK = 4          # of the built-in depth batch


def verify_config():
    from deplex_tpu_torch.config import Config

    return Config(max_planes=8, max_region_growing_rounds=16)


def synth_depth(batch: int, height: int = VERIFY_H, width: int = VERIFY_W) -> np.ndarray:
    """(B, H, W) uint16: two tilted walls per frame, offset by the frame
    index so that every frame differs."""
    u = np.arange(width, dtype=np.float32)[None, :]
    v = np.arange(height, dtype=np.float32)[:, None]
    frames = []
    for b in range(batch):
        left = 1200.0 + 40.0 * b + 3.0 * u + 1.5 * v
        right = 2400.0 + 25.0 * b + 1.0 * u + 4.0 * v
        frames.append(np.where(u < width // 2, left, right))
    return np.stack(frames).astype(np.uint16)


def synth_intrinsics(height: int = VERIFY_H, width: int = VERIFY_W) -> np.ndarray:
    return np.array([[525.0, 0.0, width / 2 - 0.5],
                     [0.0, 525.0, height / 2 - 0.5],
                     [0.0, 0.0, 1.0]], np.float32)


def synth_ba_problem(num_keyframes: int, num_landmarks: int = VERIFY_BA_LANDMARKS):
    """A plane-BA problem as numpy arrays: random planes seen by every
    keyframe from perturbed ground-truth poses (pose 0, the gauge, exact)."""
    from deplex_tpu_torch.slam.ba import BAProblem
    from deplex_tpu_torch.slam.lie import _matvec, se3_exp, so3_exp
    from deplex_tpu_torch.slam.planes import to_cp, transform_plane

    rng = np.random.default_rng(1234)
    n_w = rng.normal(size=(num_landmarks, 3)).astype(np.float32)
    n_w /= np.linalg.norm(n_w, axis=1, keepdims=True)
    d_w = rng.uniform(500, 3000, size=num_landmarks).astype(np.float32)
    R_true = so3_exp(torch.from_numpy(
        rng.normal(size=(num_keyframes, 3)).astype(np.float32) * 0.1))
    t_true = torch.from_numpy((rng.normal(size=(num_keyframes, 3)) * 50).astype(np.float32))
    n_c, d_c = transform_plane(R_true[:, None], t_true[:, None],
                               torch.from_numpy(n_w), torch.from_numpy(d_w))
    xi = rng.normal(size=(num_keyframes, 6)).astype(np.float32) * \
        np.array([0.02, 0.02, 0.02, 10.0, 10.0, 10.0], np.float32)
    xi[0] = 0.0
    dR, dt = se3_exp(torch.from_numpy(xi))
    obs_lm = np.broadcast_to(np.arange(num_landmarks, dtype=np.int32),
                             (num_keyframes, num_landmarks)).copy()
    return BAProblem(
        R=(dR @ R_true).numpy(), t=(_matvec(dR, t_true) + dt).numpy(),
        eta=to_cp(torch.from_numpy(n_w), torch.from_numpy(d_w)).numpy(),
        obs_normal=n_c.numpy(), obs_d=d_c.numpy(), obs_lm=obs_lm,
        obs_w=np.ones((num_keyframes, num_landmarks), np.float32))


def write_slam_job(path: str, slam) -> None:
    """Save a PlaneSlam's state (PATH.npz) and the arguments that rebuild it
    (PATH.json), for --slam-checkpoint PATH."""
    slam.save(path)
    spec = {"image_height": slam.height, "image_width": slam.width,
            "config": dataclasses.asdict(slam.config),
            "max_landmarks": int(slam.map.d.shape[0])}
    pathlib.Path(path + ".json").write_text(json.dumps(spec))


def load_slam_job(path: str, device):
    from deplex_tpu_torch.config import Config
    from deplex_tpu_torch.slam.frontend import PlaneSlam

    spec = json.loads(pathlib.Path(path + ".json").read_text())
    slam = PlaneSlam(spec["image_height"], spec["image_width"], Config(**spec["config"]),
                     max_landmarks=spec["max_landmarks"], device=device)
    slam.load(path)
    return slam


def load_rank_outputs(out_dir, world: int) -> list[dict]:
    """The proc<rank>.npz of every rank under out_dir, as dicts of arrays."""
    outs = []
    for rank in range(world):
        with np.load(pathlib.Path(out_dir) / f"proc{rank}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return outs


def _wall_ms(fn, device, reps: int) -> float:
    """Median host milliseconds of fn() over reps calls, each ending in a
    device sync (NaN when reps is 0)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)) if times else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--depth", help="npz with depth, K and config")
    ap.add_argument("--ba-problem", help="npz of BAProblem fields")
    ap.add_argument("--ba-iterations", type=int, default=4)
    ap.add_argument("--slam-checkpoint", help="PATH of PATH.npz and PATH.json")
    ap.add_argument("--refine-iterations", type=int, default=10)
    ap.add_argument("--spatial", help="npz with points, height, width and config: "
                                      "run only the spatially sharded extraction")
    ap.add_argument("--time-reps", type=int, default=0,
                    help="also time each path over this many repeats")
    args = ap.parse_args(argv)

    from deplex_tpu_torch import kernels
    from deplex_tpu_torch.config import Config
    from deplex_tpu_torch.interop import ba_problem_from_numpy
    from deplex_tpu_torch.parallel.batch import ShardedPlaneExtractor, extract_depth_batch
    from deplex_tpu_torch.parallel.distributed import (all_gather_cat, initialize,
                                                       local_batch_slice, make_mesh)
    from deplex_tpu_torch.pipeline import depth_tensor
    from deplex_tpu_torch.slam.ba import ba_step, pad_problem_keyframes, run_ba_sharded
    from deplex_tpu_torch.utils.depth_image import backproject

    dev = initialize()
    if dev is None:
        raise SystemExit("verify: no process group (start it with parallel.launcher "
                         "or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if args.spatial:
        return _spatial(args, dev)
    data_mesh, kf_mesh = make_mesh("data"), make_mesh("kf")
    kf_group = kf_mesh.get_group("kf")
    kernels.reset_launch_counts()

    # --- 1. extraction over the 'data' ranks ------------------------------
    if args.depth:
        with np.load(args.depth) as f:
            depth, K = f["depth"], f["K"]
            cfg = Config(**json.loads(str(f["config"])))
    else:
        depth = synth_depth(FRAMES_PER_RANK * world)
        K, cfg = synth_intrinsics(), verify_config()
    B, H, W = depth.shape
    start, size = local_batch_slice(B, data_mesh)
    local = depth_tensor(depth[start:start + size], dev)
    labels = extract_depth_batch(local, K, cfg).cpu().numpy()
    clouds = np.stack([backproject(d, K) for d in depth])
    points_labels = ShardedPlaneExtractor(H, W, cfg, mesh=data_mesh, device=dev).process(clouds)
    launches = kernels.launch_counts()
    extract_ms = _wall_ms(lambda: extract_depth_batch(local, K, cfg), dev, args.time_reps)

    # --- 2. keyframe-sharded BA --------------------------------------------
    if args.ba_problem:
        with np.load(args.ba_problem) as f:
            fields = {k: f[k] for k in f.files}
    else:
        fields = synth_ba_problem(8)._asdict()
    problem = ba_problem_from_numpy(fields, device=dev)
    Kf = problem.obs_d.shape[0]
    padded = pad_problem_keyframes(problem, -(-Kf // world) * world)
    per = padded.obs_d.shape[0] // world
    lo = dist.get_rank(kf_group) * per
    shard = padded._replace(**{f: getattr(padded, f)[lo:lo + per] for f in
                               ("R", "t", "obs_normal", "obs_d", "obs_lm", "obs_w")})
    step = ba_step(shard, damping=1e-4, group=kf_group)
    step_R = all_gather_cat(step.R, kf_group)[:Kf]
    step_t = all_gather_cat(step.t, kf_group)[:Kf]
    lm = run_ba_sharded(problem, kf_mesh, iterations=args.ba_iterations)
    ba_ms = _wall_ms(lambda: run_ba_sharded(problem, kf_mesh, iterations=args.ba_iterations),
                     dev, args.time_reps)
    out = {"world_size": world, "rank": rank, "device": str(dev),
           "jax_imported": "jax" in sys.modules, "frame_idx": np.arange(start, start + size),
           "labels": labels, "points_labels": points_labels,
           "ba_R": step_R.cpu().numpy(), "ba_t": step_t.cpu().numpy(),
           "ba_eta": step.eta.cpu().numpy(), "ba_cost": step.cost.cpu().numpy(),
           "lm_R": lm.R.cpu().numpy(), "lm_t": lm.t.cpu().numpy(),
           "lm_eta": lm.eta.cpu().numpy(), "lm_cost": lm.cost.cpu().numpy(),
           "extract_ms": extract_ms, "ba_ms": ba_ms,
           **{f"launches_{name}": n for name, n in launches.items()}}

    # --- 3. PlaneSlam.refine over the 'kf' ranks ----------------------------
    if args.slam_checkpoint:
        slam = load_slam_job(args.slam_checkpoint, dev)
        tracked, tracked_map = list(slam.trajectory), slam.map
        slam.refine(iterations=args.refine_iterations, mesh=kf_mesh)
        out.update(refine_R=np.stack([R for R, _ in slam.trajectory]),
                   refine_t=np.stack([t for _, t in slam.trajectory]),
                   refine_normal=slam.map.normal.cpu().numpy(),
                   refine_d=slam.map.d.cpu().numpy())

        def refine_again():
            slam.trajectory, slam.map = list(tracked), tracked_map
            slam.refine(iterations=args.refine_iterations, mesh=kf_mesh)
        out["refine_ms"] = _wall_ms(refine_again, dev, args.time_reps)

    _finish(args, out, f"frames {start}..{start + size - 1}, launches {launches}, "
                       f"ba_cost {float(step.cost):.6f}")
    return 0


def _finish(args, out: dict, summary: str) -> None:
    """Write this rank's proc<rank>.npz, report, and leave the group."""
    rank, world = dist.get_rank(), dist.get_world_size()
    path = pathlib.Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / f"proc{rank}.npz", **out)
    print(f"verify rank {rank}/{world} on {out['device']} ({dist.get_backend()}): {summary}",
          flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _spatial(args, dev) -> int:
    """The spatial mode: one frame's cell grid over a 1-D 'space' mesh."""
    from deplex_tpu_torch import kernels
    from deplex_tpu_torch.config import Config
    from deplex_tpu_torch.parallel.distributed import make_mesh
    from deplex_tpu_torch.parallel.spatial import CELL_FLOATS, extract_planes_spatial
    from deplex_tpu_torch.pipeline import patch_size

    with np.load(args.spatial) as f:
        points, H, W = f["points"], int(f["height"]), int(f["width"])
        cfg = Config(**json.loads(str(f["config"])))
    mesh = make_mesh("space")
    world = dist.get_world_size()
    pts = torch.from_numpy(points).to(dev)
    kernels.reset_launch_counts()
    kw = dict(image_height=H, image_width=W, config=cfg, mesh=mesh, device=dev)
    labels = extract_planes_spatial(pts, **kw)
    launches = kernels.launch_counts()
    P = patch_size(H, W, cfg)
    per = -(-(H // P) // world)
    out = {"world_size": world, "rank": dist.get_rank(), "device": str(dev),
           "jax_imported": "jax" in sys.modules, "labels": labels.cpu().numpy(),
           "spatial_ms": _wall_ms(lambda: extract_planes_spatial(pts, **kw), dev,
                                  args.time_reps),
           # What the all_gather brings to each rank: every rank's cell table.
           "gathered_bytes": world * per * (W // P) * CELL_FLOATS * 4,
           **{f"launches_{name}": n for name, n in launches.items()}}
    _finish(args, out, f"spatial {W}x{H}, launches {launches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
