"""Hold N ranks of ``parallel.verify`` to one process, on any backend.

    python -m deplex_tpu_torch.tools.dist_check --nprocs 2 --backend nccl
    python -m deplex_tpu_torch.tools.dist_check --nprocs 4 --device cpu

Builds a ring of shifted TUM frames (``--frames-per-rank`` a rank) and the
built-in BA problem (``verify.synth_ba_problem``, 8 keyframes, no JAX),
computes the single-process results (``extract_depth_batch``, dense
``run_ba``) on this process's device, launches the ranks through
``parallel.launcher`` (a CUDA rank takes card LOCAL_RANK % device_count),
and fails unless: every rank launched every kernel (on CUDA ranks), the
ranks' labels equal one process's, the sharded BA agrees with the dense one
to tests/test_multiprocess.py's tolerances, and the ranks' BA results are
bit-equal. With two cards or more it also extracts the ring on the last
card while card 0 is current, which must give the same labels. Prints the
measured differences and the ranks' devices. ``chip_smoke.py`` runs the
same worker on the [slam] phase's BA problem on one card; this tool is the
check for machines with several cards (NCCL needs a card a rank).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
DATA = ROOT / "data"
R_ATOL, T_RTOL, T_ATOL, COST_RTOL, COST_ATOL = 1e-4, 5e-3, 0.2, 1e-2, 1e-4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--frames-per-rank", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    import torch

    from deplex_tpu_torch import Config, kernels
    from deplex_tpu_torch.kernels import _build
    from deplex_tpu_torch.interop import ba_problem_from_numpy
    from deplex_tpu_torch.parallel.batch import extract_depth_batch
    from deplex_tpu_torch.parallel.launcher import launch
    from deplex_tpu_torch.parallel.verify import load_rank_outputs, synth_ba_problem
    from deplex_tpu_torch.pipeline import depth_tensor, resolve_device
    from deplex_tpu_torch.slam.ba import run_ba
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        _build.library()                   # built once, before the ranks start
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
        print(f"[cards] count={torch.cuda.device_count()} {smi}", flush=True)
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K")).astype(np.float32)
    rng = np.random.default_rng(3)
    B = args.frames_per_rank * args.nprocs
    ring = np.stack([np.roll(tum.data, (int(rng.integers(0, 8)), int(rng.integers(0, 8))),
                             (0, 1)) for _ in range(B)])
    cfg = Config()
    prob = synth_ba_problem(8)
    single = extract_depth_batch(depth_tensor(ring, dev), K, cfg).cpu().numpy()
    dense = run_ba(ba_problem_from_numpy(prob._asdict(), device=dev), iterations=4)

    with tempfile.TemporaryDirectory(prefix="dist_check_") as tmp:
        work = pathlib.Path(tmp)
        np.savez(work / "ring.npz", depth=ring, K=K, config=json.dumps(dataclasses.asdict(cfg)))
        np.savez(work / "ba.npz", **{f: v for f, v in prob._asdict().items() if v is not None})
        env = {"PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
        if dev.type == "cpu":
            env["OMP_NUM_THREADS"] = "2"
        launch([sys.executable, "-m", "deplex_tpu_torch.parallel.verify", "--out",
                str(work / "out"), "--depth", str(work / "ring.npz"), "--ba-problem",
                str(work / "ba.npz"), "--ba-iterations", "4"],
               args.nprocs, device=args.device, backend=args.backend, extra_env=env,
               timeout=args.timeout)
        ranks = load_rank_outputs(work / "out", args.nprocs)

    devices = [str(o["device"]) for o in ranks]
    launches = {name: [int(o[f"launches_{name}"]) for o in ranks] for name in kernels.MODULES}
    labels = np.concatenate([o["labels"] for o in ranks])
    order = np.concatenate([o["frame_idx"] for o in ranks])
    err = {"R": max(float(np.abs(o["lm_R"] - dense.R.cpu().numpy()).max()) for o in ranks),
           "t_excess": max(float((np.abs(o["lm_t"] - dense.t.cpu().numpy())
                                  - T_RTOL * np.abs(dense.t.cpu().numpy())).max()) for o in ranks),
           "cost_excess": max(abs(float(o["lm_cost"]) - float(dense.cost))
                              - COST_RTOL * abs(float(dense.cost)) for o in ranks)}
    bit_equal = all(np.array_equal(ranks[0][k], o[k]) for o in ranks[1:]
                    for k in ("lm_R", "lm_t", "lm_eta", "ba_eta", "points_labels"))
    print(f"[dist_check] nprocs={args.nprocs} backend={args.backend or 'default'} "
          f"devices={devices} launches={launches} frames={B} "
          f"pixels_differing={int((labels != single).sum())} "
          f"ba_max_R_diff={err['R']:.3e} ba_t_excess={err['t_excess']:.3e} "
          f"ba_cost_excess={err['cost_excess']:.3e} ranks_bit_equal={bit_equal}", flush=True)
    checks = {"frames in rank order": order.tolist() == list(range(B)),
              "labels equal one process's": np.array_equal(labels, single),
              "sharded BA within tolerance": (err["R"] <= R_ATOL and err["t_excess"] <= T_ATOL
                                              and err["cost_excess"] <= COST_ATOL),
              "ranks bit-equal": bit_equal,
              "no rank imported jax": not any(bool(o["jax_imported"]) for o in ranks)}
    if dev.type == "cuda":
        checks["every kernel launched on every rank"] = all(
            n > 0 for per_rank in launches.values() for n in per_rank)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        # One process, the batch on the last card while card 0 is current:
        # the wrappers must launch on the tensors' card.
        other = torch.device("cuda", torch.cuda.device_count() - 1)
        torch.cuda.set_device(0)
        kernels.reset_launch_counts()
        there = extract_depth_batch(depth_tensor(ring, other), K, cfg)
        counts = kernels.launch_counts()
        print(f"[dist_check] cross_device={other} current=cuda:0 launches={counts} "
              f"pixels_differing={int((there.cpu().numpy() != single).sum())}", flush=True)
        checks["a batch on another card than the current one"] = (
            there.device == other and np.array_equal(there.cpu().numpy(), single)
            and all(n > 0 for n in counts.values()))
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        print(f"[dist_check] FAILED: {failed}", file=sys.stderr)
        return 1
    print("[dist_check] ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
