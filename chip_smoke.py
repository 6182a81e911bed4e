#!/usr/bin/env python3
"""Smoke run of deplex_tpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc. It
imports only numpy, torch and deplex_tpu_torch (from this checkout), and:

  1. prints the environment (torch, CUDA, nvcc, the card and its power limit);
  2. builds the CUDA kernels from deplex_tpu_torch/csrc;
  3. holds each kernel against its plain PyTorch twin on the card, at the
     main path's shapes (TUM VGA at P=10, B=8; ICL VGA at P=4, B=2; the
     points entry; a seeded batch with mixed round counts), K1's 13 planes
     bit-equal (also at P=160, its per-cell kernel); K2 also on seeded
     random directed graphs (7x13, 48x64, 50x100, 120x160 and 300x250
     cells, MSE ties inside bins) and on a serpentine wall (one winding
     corridor); K3 (adjacency and merge from the cell labels) also on seeded
     label maps and tables (coplanar, mixed, chained, full and edge cases on
     7x13, 48x64 and 120x160 cells, M = 8, 64, 100 and 128, so both of its
     instantiations run); times each kernel's own launch (K1 over two
     alternating rings, 78.6 MB) and its twin with CUDA events at the
     serving shape (TUM, B=64), beside the kernel's bound on the H100
     (``tools/kernel_bench.py``);
  4. drives the main path (BatchDepthExtractor on a B=64 ring of the TUM
     frame) with the launch counters zeroed and ``ops.merge.plane_adjacency``
     made to raise (stage 4 builds it in the kernel), checks every kernel
     ran, and checks the results: 34 planes and golden F1 >= 0.95 on TUM
     and on ICL, card labels equal to the CPU twins', the points and depth
     entries equal; then times frames/s at B=64 and the B=1 p50 latency;
  5. [ransac] drives stage 6 (the shipped RANSAC ini, B=8 TUM ring) with the
     counters zeroed: every kernel ran, labels only removed, per-plane MSE
     not worse; over eight seeded streams of draws, mean golden F1 >= 0.30
     and each survivor mass within [0.4, 1.6] of the golden's; card labels
     equal to the CPU's under the same draws; times;
  6. [slam] tracks a 30-frame warped TUM sequence at 640x480 with PlaneSlam
     (counters zeroed: every kernel ran each frame), checks the ATE bounds of
     tracking, BA and the pose graph, runs the same on the CPU twins (equal
     per-frame matches, landmarks, poses within a stated bound); times.

Any failed check raises, so the script exits non-zero. The last line is a
JSON object {"ok": true, "device": {...}}; the line before it lists each
kernel's launches, largest absolute difference from its twin over every
output compared, times, bound and share of the bound.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "data"

# Card-vs-CPU bound on the SLAM trajectory (largest absolute difference of
# any rotation entry, and of any translation in mm, over the 30 frames).
SLAM_ROTATION_TOL = 1e-5
SLAM_TRANSLATION_TOL_MM = 0.05

# Seeded streams of RANSAC draws over which the golden F1 bound is averaged.
F1_SEEDS = 8

KERNELS = {
    "cell_moments": ("deplex_tpu_torch/csrc/cellstats.cu",
                     "deplex_tpu/ops/pallas_cellstats.py:82"),
    "grow_rounds": ("deplex_tpu_torch/csrc/growing.cu",
                    "deplex_tpu/ops/pallas_growing.py:131"),
    "merge_planes": ("deplex_tpu_torch/csrc/merge.cu",
                     "deplex_tpu/ops/pallas_merge.py:158"),
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def label_f1(pred, gold) -> float:
    """Plane-label F1 with greedy per-gold-plane matching (tests/conftest.py)."""
    pred, gold = np.asarray(pred).reshape(-1), np.asarray(gold).reshape(-1)
    gold_ids, gold_counts = np.unique(gold[gold > 0], return_counts=True)
    used, tp = set(), 0
    for g in gold_ids[np.argsort(-gold_counts)]:
        overl = pred[(gold == g) & (pred > 0)]
        if overl.size == 0:
            continue
        ids, cnts = np.unique(overl, return_counts=True)
        for i in np.argsort(-cnts):
            if ids[i] not in used:
                used.add(ids[i])
                tp += int(cnts[i])
                break
    precision = tp / max(int((pred > 0).sum()), 1)
    recall = tp / max(int((gold > 0).sum()), 1)
    return 2 * precision * recall / max(precision + recall, 1e-12)


@contextlib.contextmanager
def no_plane_adjacency():
    """Inside, ``ops.merge.plane_adjacency`` raises: on the card, stage 4
    builds the adjacency in its kernel, so no path may call the plain one."""
    from deplex_tpu_torch.ops import merge as o_merge

    def forbidden(*args, **kwargs):
        raise AssertionError("ops.merge.plane_adjacency ran on the card's path")
    saved, o_merge.plane_adjacency = o_merge.plane_adjacency, forbidden
    try:
        yield
    finally:
        o_merge.plane_adjacency = saved


def cuda_ms(torch, fn, reps: int, warmup: int) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def per_plane_mse(points, labels) -> dict:
    """Plane-fit MSE per label (lambda_min / n, tests/test_refinement.py)."""
    out = {}
    for pid in np.unique(labels[labels > 0]):
        pts = points[labels == pid].astype(np.float64)
        if len(pts) >= 3:
            c = pts - pts.mean(0)
            out[int(pid)] = np.linalg.eigvalsh(c.T @ c)[0] / len(pts)
    return out


def ate_mm(trajectory, poses) -> float:
    """RMS camera-centre error of a camera-from-world trajectory
    (tests/test_slam_sequence.py)."""
    errs = [np.linalg.norm(-R.T @ t - (-Rg.T @ tg)) for (R, t), (Rg, tg) in zip(trajectory, poses)]
    return float(np.sqrt(np.mean(np.square(errs))))


def ransac_phase(torch, dev, gpu: str, tum, K_tum, batch: int = 8, cpu_frames: int = 2) -> dict:
    """Stage 6 on the card: the shipped RANSAC ini through BatchDepthExtractor
    on a ring of TUM frames (frame 0 unshifted), with its checks and times.
    Returns the path's kernel launches."""
    from deplex_tpu_torch import Config, kernels
    from deplex_tpu_torch.ops.merge import apply_label_lut, rasterize_labels
    from deplex_tpu_torch.ops.ransac import draw_ranks, refine_batch, refine_labels
    from deplex_tpu_torch.parallel.batch import BatchDepthExtractor, extract_depth_batch
    from deplex_tpu_torch.pipeline import (backproject_device, compute_cell_stats, depth_tensor,
                                           grow_planes, merge_stage)

    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val_ransac.ini"))
    require(cfg.ransac_refinement, "the RANSAC ini does not enable refinement")
    coarse_cfg = cfg.replace(ransac_refinement=False)
    H, W, P = tum.height, tum.width, cfg.patch_size
    rng = np.random.default_rng(1)
    shifts = [(int(rng.integers(1, 8)), int(rng.integers(1, 8))) for _ in range(batch - 1)]
    ring = np.stack([tum.data] + [np.roll(tum.data, s, (0, 1)) for s in shifts])
    Kt = torch.as_tensor(K_tum)

    extractor = BatchDepthExtractor(H, W, cfg, batch=batch, device=dev)
    extractor.process(ring, K_tum)                   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with no_plane_adjacency():
        refined = extractor.process(ring, K_tum).astype(np.int32)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("ransac", batch=batch, launches=launches)
    for name, n in launches.items():
        require(n > 0, f"RANSAC path: kernel {name} was not launched")
    coarse = BatchDepthExtractor(H, W, coarse_cfg, batch=batch, device=dev).process(
        ring, K_tum).astype(np.int32)
    changed = refined != coarse
    require(bool((refined[changed] == 0).all()), "RANSAC changed a label to another plane")
    improved = total = 0
    for b in range(batch):
        pts = backproject_device(depth_tensor(ring[b], "cpu"), Kt).numpy()
        mse_c, mse_r = per_plane_mse(pts, coarse[b]), per_plane_mse(pts, refined[b])
        require(bool(mse_r), f"frame {b}: refinement removed every plane")
        improved += sum(1 for p in mse_r if p in mse_c and mse_r[p] <= 1.05 * mse_c[p])
        total += len(mse_r)
    # tests/test_refinement.py: refined MSE <= 1.05 x coarse for >= 80% of planes.
    require(improved >= 0.8 * total, f"refined MSE not better on {total - improved}/{total} planes")
    say("ransac", removed_share=f"{float(changed.mean()):.4f}",
        mse_not_worse=f"{improved}/{total}")

    def stages_1_to_5(depth, device):
        """(points, labels, cell labels) of one frame, stages 1-5 on `device`."""
        src = depth_tensor(depth[None], device)
        lm, seg = grow_planes(compute_cell_stats(src, Kt, cfg), cfg)
        ml = merge_stage(lm, seg, cfg)
        return (backproject_device(src, Kt), rasterize_labels(lm, ml, H, W, P),
                apply_label_lut(lm, ml))

    def seeded_draws(cell_labels, seed):
        """Draws of a CPU generator seeded `seed`, on the cell labels' device."""
        counts = torch.bincount(cell_labels.reshape(-1).long(), minlength=cfg.max_planes + 1)
        return draw_ranks(counts[1:] * P * P, cfg.ransac_max_iterations,
                          torch.Generator().manual_seed(seed))

    kw = dict(image_width=W, patch_size=P)
    # Golden bounds on frame 0 over seeded streams of draws (seed 0 is the
    # default stream): at the 1-unit threshold one stream's F1 is noise around
    # 0.30, so the bound holds on the mean; the mass bound holds on each.
    gold = np.load(DATA / "golden" / "tum_ransac_labels.npz")["labels"]
    kept_gold = int((gold > 0).sum())
    pts0, lab0, cells0 = stages_1_to_5(ring[0], dev)
    f1s, masses = [], []
    for seed in range(F1_SEEDS):
        got = refine_labels(pts0[0], lab0[0], cfg, draws=seeded_draws(cells0[0], seed),
                            cell_labels=cells0[0], **kw).cpu().numpy()
        if seed == 0:
            require(np.array_equal(got, refined[0]), "seed-0 draws differ from the default stream")
        f1s.append(label_f1(got, gold))
        masses.append(int((got > 0).sum()) / kept_gold)
    say("ransac", frame=0, seeds=F1_SEEDS, golden_f1_mean=f"{np.mean(f1s):.4f}",
        golden_f1_default=f"{f1s[0]:.4f}", golden_f1_min=f"{min(f1s):.4f}",
        golden_f1_max=f"{max(f1s):.4f}", mass_ratio_min=f"{min(masses):.4f}",
        mass_ratio_max=f"{max(masses):.4f}", kept_golden=kept_gold)
    require(np.mean(f1s) >= 0.30, f"RANSAC golden F1 mean {np.mean(f1s)} over {F1_SEEDS} seeds")
    require(all(0.4 <= m <= 1.6 for m in masses), f"RANSAC mass ratios {masses}")

    # The card against the CPU twins, fed the same draws: the same labels.
    for b in range(cpu_frames):
        card, cpu = stages_1_to_5(ring[b], dev), stages_1_to_5(ring[b], "cpu")
        for what, x, y in zip(("points", "labels", "cell labels"), card, cpu):
            require(torch.equal(x.cpu(), y), f"frame {b}: stage 1-5 {what} differ card vs CPU")
        draws = seeded_draws(cpu[2], b)
        got = refine_labels(card[0][0], card[1][0], cfg, draws=draws.to(dev),
                            cell_labels=card[2][0], **kw)
        ref = refine_labels(cpu[0][0], cpu[1][0], cfg, draws=draws, cell_labels=cpu[2][0], **kw)
        differing = int((got.cpu() != ref).sum())
        # The default draws come from one seeded CPU stream on every device.
        default_cpu = refine_labels(cpu[0][0], cpu[1][0], cfg, cell_labels=cpu[2][0], **kw)
        default_differing = int((torch.from_numpy(refined[b]) != default_cpu).sum())
        say("ransac_card_vs_cpu", frame=b, pixels_differing=differing,
            default_draws_pixels_differing=default_differing, kept=int((ref > 0).sum()))
        require(differing == 0, f"frame {b}: card RANSAC labels differ from the CPU's")
        require(default_differing == 0, f"frame {b}: default-draw labels differ card vs CPU")

    ring_dev = depth_tensor(ring, dev)
    parts = [stages_1_to_5(ring[b], dev) for b in range(batch)]
    pts8, lab8, cells8 = (torch.cat([p[i] for p in parts]) for i in range(3))
    refine_ms = cuda_ms(torch, lambda: refine_batch(pts8, lab8, cells8, W, P, cfg), reps=5,
                        warmup=1)
    path_ms = cuda_ms(torch, lambda: extract_depth_batch(ring_dev, Kt, cfg), reps=5, warmup=1)
    coarse_ms = cuda_ms(torch, lambda: extract_depth_batch(ring_dev, Kt, coarse_cfg), reps=5,
                        warmup=1)
    say("ransac_time", batch=batch, refine_ms=f"{refine_ms:.3f}", path_ms=f"{path_ms:.3f}",
        path_without_ransac_ms=f"{coarse_ms:.3f}", gpu=repr(gpu))
    return launches


def slam_phase(torch, dev, gpu: str, tum, K_tum, frames: int = 30) -> dict:
    """PlaneSlam on the card over a warped TUM sequence at 640x480 (the
    committed golden's run, data/golden/slam_ate_tum30.json), with the same
    run on the CPU twins beside it. Returns the path's kernel launches."""
    from deplex_tpu_torch import Config, PlaneSlam, kernels
    from deplex_tpu_torch.pipeline import backproject_device, depth_tensor
    from deplex_tpu_torch.utils.warp import render_sequence, smooth_trajectory

    cfg = Config.from_ini(str(DATA / "configs" / "TUM_fr3_long_val.ini"))
    H, W = tum.height, tum.width
    K = np.asarray(K_tum, np.float32)
    poses = smooth_trajectory(frames, seed=0)
    seq = [np.clip(np.round(d), 0, 65535).astype(np.uint16)
           for d in render_sequence(tum.data, K, poses)]
    Kt = torch.as_tensor(K)
    golden = json.loads((DATA / "golden" / "slam_ate_tum30.json").read_text())

    def track(device):
        slam = PlaneSlam(H, W, cfg, max_landmarks=128, odom_iterations=10, device=device)
        counts, ms = [], []
        for depth in seq:
            t0 = time.perf_counter()
            res = slam.process_frame(backproject_device(depth_tensor(depth, device), Kt))
            counts.append((int(res.num_matched), int(res.num_new)))
            ms.append(1e3 * (time.perf_counter() - t0))
        return slam, counts, ms

    kernels.reset_launch_counts()
    with no_plane_adjacency():
        slam, counts, frame_ms = track(dev)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("slam", frames=frames, launches=launches)
    for name, n in launches.items():
        require(n >= frames, f"SLAM path: kernel {name} launched {n} times for {frames} frames")

    tracked, tracked_map = list(slam.trajectory), slam.map
    ate_track = ate_mm(slam.trajectory, poses)
    t0 = time.perf_counter()
    slam.refine(iterations=10)
    refine_ms = [1e3 * (time.perf_counter() - t0)]
    ate_ba = ate_mm(slam.trajectory, poses)
    slam.trajectory, slam.map = list(tracked), tracked_map
    t0 = time.perf_counter()
    slam.optimize_trajectory()
    pg_ms = [1e3 * (time.perf_counter() - t0)]
    ate_pg = ate_mm(slam.trajectory, poses)
    for _ in range(2):                               # warm repeats, same start
        slam.trajectory, slam.map = list(tracked), tracked_map
        t0 = time.perf_counter()
        slam.refine(iterations=10)
        refine_ms.append(1e3 * (time.perf_counter() - t0))
        slam.trajectory = list(tracked)
        t0 = time.perf_counter()
        slam.optimize_trajectory()
        pg_ms.append(1e3 * (time.perf_counter() - t0))
    ref_ate = golden["ate_rmse_mm"]
    landmarks = int(tracked_map.count)
    say("slam", ate_tracking_mm=f"{ate_track:.3f}", ate_ba_mm=f"{ate_ba:.3f}",
        ate_pose_graph_mm=f"{ate_pg:.3f}", landmarks=landmarks,
        golden=f"{ref_ate['tracking']}/{ref_ate['ba']}/{ref_ate['pose_graph']}mm,"
               f"{golden['landmarks']}landmarks")
    require(len(slam.trajectory) == frames, "trajectory length")
    require(ate_track < 300.0, f"tracking ATE {ate_track} mm")
    require(ate_ba <= 1.05 * ate_track, f"BA ATE {ate_ba} > 1.05 x tracking {ate_track}")
    require(ate_pg <= 1.05 * ate_track, f"pose-graph ATE {ate_pg} > 1.05 x tracking {ate_track}")

    # The same sequence on the CPU twins: the same matches, frame by frame.
    cpu, cpu_counts, _ = track("cpu")
    dR = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(tracked, cpu.trajectory))
    dt = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(tracked, cpu.trajectory))
    say("slam_card_vs_cpu", frames_equal=sum(a == b for a, b in zip(counts, cpu_counts)),
        landmarks_card=landmarks, landmarks_cpu=int(cpu.map.count),
        max_rotation_diff=f"{dR:.3e}", max_translation_diff_mm=f"{dt:.3e}")
    require(counts == cpu_counts, f"per-frame (matched, new) differ: {counts} vs {cpu_counts}")
    require(landmarks == int(cpu.map.count), "landmark counts differ card vs CPU")
    require(dR <= SLAM_ROTATION_TOL and dt <= SLAM_TRANSLATION_TOL_MM,
            f"card poses off the CPU's by {dR} (rotation) / {dt} mm")
    say("slam_time", process_frame_p50_ms=f"{float(np.median(frame_ms)):.3f}",
        refine10_ms=f"{min(refine_ms[1:]):.3f}", refine10_first_ms=f"{refine_ms[0]:.3f}",
        optimize_trajectory_ms=f"{min(pg_ms[1:]):.3f}", optimize_first_ms=f"{pg_ms[0]:.3f}",
        gpu=repr(gpu))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import deplex_tpu_torch
    pkg = pathlib.Path(deplex_tpu_torch.__file__).resolve()
    require(ROOT in pkg.parents, f"deplex_tpu_torch imported from {pkg}, not this checkout")

    from deplex_tpu_torch import Config, PlaneExtractor, kernels
    from deplex_tpu_torch.kernels import _build
    from deplex_tpu_torch.kernels import cellstats as k_cells
    from deplex_tpu_torch.kernels import growing as k_grow
    from deplex_tpu_torch.kernels import merge as k_merge
    from deplex_tpu_torch.ops import cellstats as o_cells
    from deplex_tpu_torch.ops import growing as o_grow
    from deplex_tpu_torch.ops import merge as o_merge
    from deplex_tpu_torch.parallel.batch import BatchDepthExtractor, extract_depth_batch
    from deplex_tpu_torch.pipeline import compute_cell_stats, depth_tensor
    from deplex_tpu_torch.tools import kernel_bench as bench
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    # --- 1. environment ----------------------------------------------------
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi0 = smi.splitlines()[0].strip()
    dev = torch.device("cuda", 0)
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=run([nvcc, "--version"]).splitlines()[-1].replace(" ", "_"),
        gpu=repr(smi0))

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    say("build", seconds=f"{build_s:.1f}", library=_build.library_path().name)
    for ln in ptxas:
        print("  ptxas:", ln)

    # --- inputs ------------------------------------------------------------
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K_tum = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    icl = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    K_icl = read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))
    K_t = torch.as_tensor(K_tum)
    cfg_tum = Config()
    cfg_icl = Config.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    H, W = tum.height, tum.width
    rng = np.random.default_rng(0)

    def rolled(depth, n):
        """n distinct frames: small shifts of one depth map."""
        return np.stack([np.roll(depth, (int(rng.integers(0, 8)), int(rng.integers(0, 8))),
                                 (0, 1)) for _ in range(n)])

    def staircases(n, h=120, w=160):
        """Synthetic scenes of random boxes: many touching segments to merge."""
        frames = []
        for _ in range(n):
            z = np.full((h, w), 4000, np.uint16)
            for _ in range(6):
                r0, c0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
                z[r0:r0 + 40, c0:c0 + 40] = int(rng.uniform(2000, 6000))
            frames.append(z)
        return np.stack(frames)

    K_syn = np.array([[200.0, 0, 80.0], [0, 200.0, 60.0], [0, 0, 1]], np.float32)
    quadrants = np.stack([tum.data[:240, :320], tum.data[240:, :320],
                          tum.data[:240, 320:], tum.data[240:, 320:]])
    cfg_mixed = Config(max_region_growing_rounds=128)
    cases = [  # name, depth batch, K, config
        ("tum_b8", rolled(tum.data, 8), K_tum, cfg_tum),
        ("icl_b2", rolled(icl.data, 2), K_icl, cfg_icl),
        ("mixed_rounds_b4", quadrants, K_tum, cfg_mixed),
        ("staircases_b4", staircases(4), K_syn, cfg_tum),
    ]

    # --- 3. each kernel against its twin on the card ------------------------
    # The largest absolute difference from the twin, over every output compared.
    errs = {name: [] for name in KERNELS}

    def max_abs_diff(got, ref) -> float:
        return max(float((a - b).abs().max()) for a, b in zip(got, ref))

    def check_moments(name, src, K, cfg):
        got = k_cells.cell_moments(src, K, cfg)
        ref = o_cells.cell_moments_reference(src, K, cfg)
        for f in ("nr_valid", "disc_h", "disc_v"):
            require(torch.equal(getattr(got, f), getattr(ref, f)), f"{name}: {f} differs")
        torch.testing.assert_close(got.coord_sum, ref.coord_sum, rtol=1e-5, atol=1e-2)
        tr = torch.diagonal(ref.scatter, dim1=-2, dim2=-1).sum(-1)
        serr = (got.scatter - ref.scatter).abs()
        require(bool((serr <= 1e-4 * tr[..., None, None] + 1e-2).all()),
                f"{name}: scatter off by {float(serr.max())}")
        P = o_cells.patch_size(src.shape[1], src.shape[2], cfg)
        sg, sr = o_cells.finalize_cell_stats(got, P, cfg), o_cells.finalize_cell_stats(ref, P, cfg)
        require(torch.equal(sg.planar, sr.planar),
                f"{name}: planar mask differs in {int((sg.planar != sr.planar).sum())} cells")
        torch.testing.assert_close(sg.tol, sr.tol, rtol=1e-4, atol=0)
        err = max_abs_diff(got, ref)   # all 13 moment planes
        errs["cell_moments"].append(err)
        bit_equal = all(torch.equal(getattr(got, f), getattr(ref, f)) for f in got._fields)
        say("k1", case=name, planar_cells=int(sg.planar.sum()), max_abs_err=err,
            scatter_max_rel=float((serr / (tr[..., None, None] + 1)).max()),
            bit_equal=bit_equal)
        require(bit_equal, f"{name}: K1's moment planes are not bit-equal to the twin's")
        return sg

    def check_rounds(name, stats, cfg):
        check_rounds_on(name, *bench.rounds_inputs(stats, cfg), cfg)

    def check_rounds_on(name, bins, mse, packed, cfg):
        got = k_grow.grow_rounds_loop(bins, mse, packed, cfg)
        edges, planar = bench.unpack_edges(packed)
        ref = o_grow.grow_rounds_loop(bins, mse, edges, planar, cfg)
        for f, a, b in zip(("round_map", "seeds", "nr_rounds"), got, ref):
            require(torch.equal(a, b), f"{name}: {f} differs")
        err = max_abs_diff(got, ref)
        errs["grow_rounds"].append(err)
        say("k2", case=name, nr_rounds=got[2].tolist(), max_abs_err=err)

    def check_merge(name, stats, cfg):
        rounds = k_grow.grow_rounds(stats, cfg)
        check_merge_on(name, *o_grow.finalize_rounds(rounds, cfg), cfg)

    def check_merge_on(name, labels_map, segments, cfg):
        ml_got, m_got = k_merge.merge_planes(labels_map, segments, cfg)
        ml_ref, m_ref = o_merge.merge_planes_from_labels(labels_map, segments, cfg)
        require(torch.equal(ml_got, ml_ref), f"{name}: merge_labels differ")
        torch.testing.assert_close(m_got.n, m_ref.n, rtol=1e-4, atol=0)
        torch.testing.assert_close(m_got.normal, m_ref.normal, rtol=0, atol=1e-4)
        torch.testing.assert_close(m_got.mean, m_ref.mean, rtol=1e-4, atol=1e-2)
        torch.testing.assert_close(m_got.d, m_ref.d, rtol=1e-4, atol=1e-2)
        tr = torch.diagonal(m_ref.scatter, dim1=-2, dim2=-1).sum(-1)
        require(bool(((m_got.scatter - m_ref.scatter).abs()
                      <= 1e-4 * tr[..., None, None] + 1e-2).all()), f"{name}: scatter differs")
        diffs = {f: max_abs_diff([getattr(m_got, f)], [getattr(m_ref, f)])
                 for f in ("n", "coord_sum", "scatter", "normal", "mean", "d")}
        diffs["merge_labels"] = max_abs_diff([ml_got], [ml_ref])
        err = max(diffs.values())
        errs["merge_planes"].append(err)
        say("k3", case=name, nr_planes=segments.nr_planes.tolist(),
            merged=int((ml_got != torch.arange(cfg.max_planes, device=dev)).sum()),
            max_abs_err=err, worst=max(diffs, key=diffs.get),
            normal_max_abs_err=diffs["normal"],
            scatter_max_abs=float(m_ref.scatter.abs().max()))

    for name, batch, K, cfg in cases:
        src = depth_tensor(batch, dev)
        stats = check_moments(name, src, torch.as_tensor(K), cfg)
        check_rounds(name, stats, cfg)
        check_merge(name, stats, cfg)
    pts = torch.as_tensor(tum.transform_to_pcd(K_tum), device=dev).reshape(1, H, W, 3)
    check_moments("tum_points_b1", pts.contiguous(), None, cfg_tum)

    # K1 on a patch too large for its band kernel (one thread a cell from
    # global memory).
    check_moments("tum_p160_b2", depth_tensor(rolled(tum.data, 2), dev), K_t,
                  Config(patch_size=160))

    # K2 on adversarial inputs: seeded random directed graphs (grids up to
    # ICL's, one over 64 columns that is not a multiple of 64, one over
    # 65,535 cells that runs on the global workspace; MSE ties inside bins;
    # asymmetric edges) and a serpentine wall through K1.
    for batch, gh, gw in ((4, 7, 13), (4, 48, 64), (4, 50, 100), (4, 120, 160), (2, 300, 250)):
        arrays = bench.random_rounds_case(rng, batch, gh, gw)
        check_rounds_on(f"random_{gh}x{gw}_b{batch}",
                        *(torch.from_numpy(a).to(dev) for a in arrays), cfg_tum)
    # K3 on seeded label maps and tables: every kind on three grids, at
    # M = 64 (the warp kernel of the shipped configs), 8 (a part of a
    # warp), 100 and 128 (the block kernel, multi-word masks).
    for (gh, gw) in ((7, 13), (48, 64), (120, 160)):
        for M in (64, 8, 100, 128):
            for kind in bench.MERGE_KINDS:
                lm_case, seg_case = bench.merge_case_tensors(
                    bench.random_merge_case(rng, 4, gh, gw, M, kind), dev)
                check_merge_on(f"{kind}_{gh}x{gw}_m{M}_b4", lm_case, seg_case,
                               cfg_tum.replace(max_planes=M))

    serp = depth_tensor(np.broadcast_to(bench.serpentine_depth(H, W, cfg_tum.patch_size),
                                        (64, H, W)), dev)
    serp_stats = check_moments("serpentine_b64", serp, K_t, cfg_tum)
    serp_in = bench.rounds_inputs(serp_stats, cfg_tum)
    check_rounds_on("serpentine_b64", *serp_in, cfg_tum)
    serp_ms = bench.cuda_ms(bench.rounds_launcher(_build.library(), *serp_in, cfg_tum)[0],
                            reps=20, prime=True)
    say("k2_serpentine", batch=64, planar_cells=int(serp_stats.planar[0].sum()),
        ms=f"{serp_ms:.4f}", gpu=repr(smi0))

    # Times at the serving shape: TUM, B=64. A kernel's own time is that of
    # its launch on inputs and outputs allocated once (tools/kernel_bench),
    # queued behind a spin kernel; the wrapper's and the twin's are not.
    B = 64
    ring = depth_tensor(np.broadcast_to(tum.data, (B, H, W)), dev)
    moments = k_cells.cell_moments(ring, K_t, cfg_tum)
    stats64 = o_cells.finalize_cell_stats(moments, cfg_tum.patch_size, cfg_tum)
    bins64 = o_grow.normal_bins(stats64.normal, stats64.planar, 20).to(torch.int32).contiguous()
    edges64 = o_grow.admissibility_edges(stats64, cfg_tum)
    packed64 = o_grow.pack_edges(edges64, stats64.planar).contiguous()
    lm64, seg64 = o_grow.finalize_rounds(k_grow.grow_rounds(stats64, cfg_tum), cfg_tum)
    lib = _build.library()
    rings = [depth_tensor(rolled(tum.data, B), dev) for _ in range(2)]
    launch_k1 = [bench.moments_launcher(lib, r, K_t, cfg_tum)[0] for r in rings]
    timing = {
        "cell_moments": (bench.alternate(launch_k1),
                         lambda: k_cells.cell_moments(ring, K_t, cfg_tum),
                         lambda: o_cells.cell_moments_reference(ring, K_t, cfg_tum)),
        "grow_rounds": (bench.rounds_launcher(lib, bins64, stats64.mse, packed64, cfg_tum)[0],
                        lambda: k_grow.grow_rounds_loop(bins64, stats64.mse, packed64, cfg_tum),
                        lambda: o_grow.grow_rounds_loop(bins64, stats64.mse, edges64,
                                                        stats64.planar, cfg_tum)),
        "merge_planes": (bench.merge_launcher(lib, lm64, seg64, cfg_tum)[0],
                         lambda: k_merge.merge_planes(lm64, seg64, cfg_tum),
                         lambda: o_merge.merge_planes_from_labels(lm64, seg64, cfg_tum)),
    }
    costs = {"cell_moments": bench.moments_cost(rings[0], cfg_tum),
             "grow_rounds": (bench.rounds_cost(bins64, cfg_tum), 0),
             "merge_planes": (bench.merge_cost(lm64, seg64), 0)}
    times = {}
    for name, (kern, wrapped, plain) in timing.items():
        ms = bench.cuda_ms(kern, reps=50, warmup=3, prime=True)
        bound_ms, bound_by = bench.bound(*costs[name])
        times[name] = {"ms": ms, "wrapper_ms": cuda_ms(torch, wrapped, reps=20, warmup=3),
                       "plain_ms": cuda_ms(torch, plain, reps=3, warmup=1),
                       "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms, "bound_by": bound_by,
                       "share_of_bound": bound_ms / ms, "library_ms": None}
        say("time", kernel=name, batch=B, **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                                              for k, v in times[name].items()}, gpu=repr(smi0))

    # Where the main path's time goes, stage by stage, at B=64.
    rounds64 = k_grow.grow_rounds(stats64, cfg_tum)
    rm64, seeds64, _ = k_grow.grow_rounds_loop(bins64, stats64.mse, packed64, cfg_tum)
    ml64, _ = k_merge.merge_planes(lm64, seg64, cfg_tum)
    stages = {
        "k1_cell_moments": lambda: k_cells.cell_moments(ring, K_t, cfg_tum),
        "finalize_cell_stats": lambda: o_cells.finalize_cell_stats(moments, 10, cfg_tum),
        "bins_edges": lambda: (o_grow.normal_bins(stats64.normal, stats64.planar, 20),
                               o_grow.pack_edges(o_grow.admissibility_edges(stats64, cfg_tum),
                                                 stats64.planar)),
        "k2_grow_rounds": timing["grow_rounds"][1],
        "region_sums": lambda: o_grow.region_sums(rm64, seeds64, stats64, 256),
        "finalize_rounds": lambda: o_grow.finalize_rounds(rounds64, cfg_tum),
        "stage4_k3_merge_planes": timing["merge_planes"][1],
        "rasterize": lambda: o_merge.rasterize_labels(lm64, ml64, H, W, 10),
        "whole_path": lambda: extract_depth_batch(ring, K_t, cfg_tum),
    }
    stage_ms = {name: cuda_ms(torch, fn, reps=10, warmup=2) for name, fn in stages.items()}
    say("stages", batch=B, **{k: f"{v:.4f}" for k, v in stage_ms.items()})

    # --- 4. the main path, end to end ---------------------------------------
    extractor = BatchDepthExtractor(H, W, cfg_tum, batch=B, device=dev)
    ring_host = np.broadcast_to(tum.data, (B, H, W))
    extractor.process(ring_host, K_tum)              # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with no_plane_adjacency():
        labels64 = extractor.process(ring_host, K_tum)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say("main_path", batch=B, launches=launches)
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    gold_tum = np.load(DATA / "golden" / "tum_default_labels.npz")["labels"]
    require(labels64.shape == (B, H * W), f"labels shape {labels64.shape}")
    require(bool((labels64 == labels64[0]).all()), "frames of one ring disagree")
    tum_labels = labels64[0].astype(np.int32)
    planes_tum = int(tum_labels.max())
    f1_tum = label_f1(tum_labels, gold_tum)
    say("tum", planes=planes_tum, f1=f"{f1_tum:.4f}", reference_f1="0.983", reference_planes=34)
    require(planes_tum == 34, f"TUM: {planes_tum} planes, expected 34")
    require(f1_tum >= 0.95, f"TUM: F1 {f1_tum}")

    icl_card = PlaneExtractor(icl.height, icl.width, cfg_icl, device=dev)
    with no_plane_adjacency():
        icl_labels = icl_card.process_depth(icl.data, K_icl)
    f1_icl = label_f1(icl_labels, np.load(DATA / "golden" / "icl_ini_labels.npz")["labels"])
    say("icl", planes=int(icl_labels.max()), f1=f"{f1_icl:.4f}", reference_f1="0.972",
        reference_planes=44)
    require(f1_icl >= 0.95, f"ICL: F1 {f1_icl}")

    # The card against the plain twins on the CPU, frame by frame: the same
    # labels. ICL at P=4 is the sharp case: lambda_min is float32 noise
    # there, so one last bit of a cell normal can reorder the growing rounds.
    for name, img, K, cfg, card in (("tum", tum, K_tum, cfg_tum, tum_labels),
                                    ("icl", icl, K_icl, cfg_icl, icl_labels)):
        cpu = PlaneExtractor(img.height, img.width, cfg, device="cpu").process_depth(img.data, K)
        Kt = torch.as_tensor(K)
        s_card = compute_cell_stats(depth_tensor(img.data[None], dev), Kt, cfg)
        s_cpu = compute_cell_stats(depth_tensor(img.data[None], "cpu"), Kt, cfg)
        differing = int((cpu != card).sum())
        say("card_vs_cpu", frame=name, pixels_differing=differing,
            cell_stats_bit_equal=all(torch.equal(a.cpu(), b) for a, b in zip(s_card, s_cpu)))
        require(differing == 0,
                f"{name}: card labels differ from the CPU twins' in {differing} pixels")
    tum_card = PlaneExtractor(H, W, cfg_tum, device=dev)
    via_points = tum_card.process(tum.transform_to_pcd(K_tum))
    via_depth = tum_card.process_depth(tum.data, K_tum)
    require(np.array_equal(via_points, via_depth), "process(points) != process_depth")
    require(np.array_equal(via_depth, tum_labels), "B=1 labels differ from the B=64 batch's")
    ex8 = BatchDepthExtractor(H, W, cfg_tum, batch=8, device=dev)
    batches = [rolled(tum.data, 8) for _ in range(3)]
    streamed = list(ex8.process_stream(batches, K_tum, max_in_flight=2))
    require(len(streamed) == 3 and all(np.array_equal(o, ex8.process(b, K_tum))
                                       for b, o in zip(batches, streamed)),
            "process_stream labels differ from process")
    say("agree", points_vs_depth="equal", b1_vs_b64="equal", stream_batches=len(streamed))

    # Throughput at B=64 (device-resident ring of two buffers, labels on the
    # card) and the B=1 latency of a user call (host depth in, host labels out).
    extract_depth_batch(rings[0], K_tum, cfg_tum)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for i in range(iters):
        extract_depth_batch(rings[i % 2], K_tum, cfg_tum)
    torch.cuda.synchronize()
    fps = iters * B / (time.perf_counter() - t0)
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        tum_card.process_depth(tum.data, K_tum)
        lat.append(time.perf_counter() - t0)
    p50_ms = 1e3 * float(np.median(lat))
    say("e2e", frames_per_s=f"{fps:.1f}", batch=B, b1_p50_ms=f"{p50_ms:.3f}", gpu=repr(smi0))

    # --- 5. stage 6 (RANSAC) and the SLAM stack, each with its own counts ---
    by_path = {"main": launches,
               "ransac": ransac_phase(torch, dev, smi0, tum, K_tum),
               "slam": slam_phase(torch, dev, smi0, tum, K_tum)}

    kernel_rows = [{"name": name, "route": "cuda", "source": KERNELS[name][0],
                    "replaces": KERNELS[name][1], "launches": launches[name],
                    "launches_by_path": {p: n[name] for p, n in by_path.items()},
                    "max_abs_err": max(errs[name]), **times[name]} for name in KERNELS]

    print(smi0)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
