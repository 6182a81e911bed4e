"""What the measurement tools share: the device they run on, the card's
name and power limit beside every time, the one timer of the repository's
tools (CUDA events on the card after a warm-up, the host clock on the CPU),
the greedy plane matching and the golden-label F1 built on it, the launch of
a tool's ranks, a tool's run in other checkouts (each in a fresh process, in
turns A B B A), and where a report may be written (never under the
repository's ``data/``).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from deplex_tpu_torch.pipeline import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[2]
DATA = ROOT / "data"
TUM_PNG = DATA / "tum" / "1341848230.910894.png"
TUM_K = DATA / "configs" / "TUM_fr3_long_val.K"


def device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card, which must exist) or cpu (the twins)")


def card_info(device) -> dict:
    """The device, and for a card its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (one line a card; the device's own line)."""
    dev = resolve_device(device)
    info = {"device": str(dev), "gpu": None}
    if dev.type == "cuda":
        smi = shutil.which("nvidia-smi")
        if smi:
            lines = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                   capture_output=True, text=True).stdout.splitlines()
            index = dev.index if dev.index is not None else torch.cuda.current_device()
            info["gpu"] = lines[index].strip() if index < len(lines) else None
        if info["gpu"] is None:
            info["gpu"] = f"{torch.cuda.get_device_name(dev)}, power limit not measured"
    else:
        info["host_cpus"] = os.cpu_count()
    return info


# A spin of about 10 ms on the card ahead of the timed launches (cycles).
PRIME_CYCLES = 20_000_000


def mean_ms(fn, reps: int, warmup: int = 3, prime: bool = False, device=None) -> float:
    """Mean milliseconds per call of fn(), after `warmup` calls: CUDA events
    on a card, the host clock when `device` is the CPU. With `prime`, a spin
    kernel runs first so that the host queues the launches while the card is
    busy: they then run back to back, and a kernel shorter than its launch on
    the host is timed by the card, not by the host."""
    for _ in range(warmup):
        fn()
    if device is not None and torch.device(device).type == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prime:
        torch.cuda._sleep(PRIME_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def match_planes(pred: np.ndarray, gold: np.ndarray) -> dict:
    """Greedy per-golden-plane matching, largest golden plane first, each
    to its most overlapping predicted plane not yet taken:
    {gold_id: pred_id or None}."""
    gold_ids, gold_counts = np.unique(gold[gold > 0], return_counts=True)
    used, out = set(), {}
    for g in gold_ids[np.argsort(-gold_counts)]:
        overl = pred[(gold == g) & (pred > 0)]
        out[int(g)] = None
        if overl.size == 0:
            continue
        ids, cnts = np.unique(overl, return_counts=True)
        for i in np.argsort(-cnts):
            if ids[i] not in used:
                used.add(int(ids[i]))
                out[int(g)] = int(ids[i])
                break
    return out


def label_f1(pred, gold) -> float:
    """Plane-label F1 over the pixels of the `match_planes` pairs (the
    metric of the reference package's tests)."""
    pred, gold = np.asarray(pred).reshape(-1), np.asarray(gold).reshape(-1)
    tp = sum(int(((gold == g) & (pred == p)).sum())
             for g, p in match_planes(pred, gold).items() if p is not None)
    precision = tp / max(int((pred > 0).sum()), 1)
    recall = tp / max(int((gold > 0).sum()), 1)
    return 2 * precision * recall / max(precision + recall, 1e-12)


def rolled_ring(depth: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n distinct frames: `depth` rolled by 0-7 rows and columns, seeded."""
    rng = np.random.default_rng(seed)
    return np.stack([np.roll(depth, (int(rng.integers(0, 8)), int(rng.integers(0, 8))), (0, 1))
                     for _ in range(n)])


def sweep_backend(dev: torch.device, ranks) -> str:
    """One backend for a sweep over rank counts: NCCL when every rank can
    have a card of its own, else gloo (ranks share a card, which NCCL
    refuses)."""
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    return "nccl" if cards >= max(ranks) else "gloo"


def launch_workers(module: str, args: list, ranks: int, dev: torch.device, backend: str,
                   timeout: float) -> list[dict]:
    """Run ``python -m <module> --out DIR <args>`` as `ranks` ranks of one
    group (``parallel.launcher``); returns the ``proc<rank>.npz`` each rank
    wrote under DIR (``parallel.verify.load_rank_outputs``)."""
    from deplex_tpu_torch.parallel.launcher import launch
    from deplex_tpu_torch.parallel.verify import load_rank_outputs

    env = {"PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    with tempfile.TemporaryDirectory(prefix="deplex_ranks_") as work:
        launch([sys.executable, "-m", module, "--out", work, *map(str, args)],
               ranks, device=dev.type, backend=backend, extra_env=env, timeout=timeout)
        return load_rank_outputs(work, ranks)


def checkout_turns(roots: list, passes: int = 2) -> list:
    """The checkouts in turns: in order, then reversed, ``passes`` times
    (A B B A ...), so that a drift of the card's clock falls on each alike."""
    return [r for i in range(passes) for r in (roots if i % 2 == 0 else roots[::-1])]


def run_in_checkout(root, script, args: list, timeout: float) -> dict:
    """``python script args`` in a fresh process run from checkout ``root``
    with it first on PYTHONPATH, so that it imports that checkout's
    ``deplex_tpu_torch`` (and builds its kernels there). Returns the last
    JSON object line it printed, with its ``returncode`` and, where it
    printed none or failed, the tail of its ``stderr``."""
    root = pathlib.Path(root).resolve()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, str(pathlib.Path(script).resolve()), *map(str, args)],
                          cwd=str(root), env=env, capture_output=True, text=True,
                          timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    run = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or not lines:
        run["stderr"] = proc.stderr[-3000:]
    run["returncode"] = proc.returncode
    return run


def write_report(path, report: dict) -> pathlib.Path:
    """Write `report` as JSON to `path`; refuses a path under ``data/``,
    which holds the committed goldens."""
    out = pathlib.Path(path).resolve()
    if DATA.resolve() in out.parents:
        raise ValueError(f"refusing to write {out}: data/ holds the committed goldens")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    return out
