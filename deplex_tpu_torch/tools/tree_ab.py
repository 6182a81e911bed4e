#!/usr/bin/env python3
"""The main path's end-to-end numbers for several checkouts, in turns on one
card: what a change moved, beside the tree it started from.

    python3 -m deplex_tpu_torch.tools.tree_ab --checkouts DIR,DIR[,...] [--rounds 2]

Run from the repository root on a machine with a CUDA card. Each DIR is the
root of a checkout (this one is ``.``; unpack another revision with
``git archive <rev> | tar -x -C build/parent``). The checkouts run in turns
A B ... B A (``--rounds`` passes, every other one reversed), each turn a
fresh process that imports ``deplex_tpu_torch`` from its checkout (its
kernels built in that checkout's ``build/``; ``_common.run_in_checkout``)
and measures, through entry points every revision since the compiled
graphs has:

  tum_b64_frames_per_s     TUM B=64 over a resident ring of two batches,
                           eager and captured (``tools.graphs.tum_timings``);
  b1_process_depth_p50_ms  ``PlaneExtractor.process_depth`` of the TUM
                           frame, eager function and captured;
  tum_b64_pool_bytes       the pool of the TUM B=64 graph;
  icl_b64_frames_per_s     ICL-NUIM with its ini (P=4) at B=64, captured
                           (``extract_depth_batch_jit`` over two batches);
  icl_b64_pool_bytes       the pool of that graph.

Lines: ``[tree_ab] turn=N checkout=DIR`` with the numbers, then the last
line, a JSON object with every turn and the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

_MEASURE = "--measure-this-checkout"


def measure() -> dict:
    """One turn: the numbers of the checkout ``deplex_tpu_torch`` is imported
    from (PYTHONPATH)."""
    import itertools

    import numpy as np
    import torch

    import deplex_tpu_torch
    from deplex_tpu_torch import Config, compiled
    from deplex_tpu_torch.parallel.batch import depth_batch_graph, extract_depth_batch_jit
    from deplex_tpu_torch.pipeline import depth_tensor
    from deplex_tpu_torch.tools._common import DATA, rolled_ring
    from deplex_tpu_torch.tools.graphs import tum_timings
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    dev = torch.device("cuda", 0)
    tum = DepthImage(str(DATA / "tum" / "1341848230.910894.png")).data
    K = np.asarray(read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K")), np.float32)
    icl = DepthImage(str(DATA / "icl_nuim" / "0.png")).data
    K_icl = np.asarray(read_intrinsics(str(DATA / "configs" / "ICL_living_room.K")), np.float32)
    cfg_icl = Config.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    out = {"package": str(pathlib.Path(deplex_tpu_torch.__file__).resolve().parent)}
    out.update(tum_timings(dev, tum, K))
    out["tum_b64_pool_bytes"] = depth_batch_graph((64, *tum.shape), Config(), dev).pool_bytes
    compiled.clear()
    rings = [depth_tensor(rolled_ring(icl, 64, seed=s), dev) for s in (0, 1)]
    turn = itertools.count()

    def call():
        return extract_depth_batch_jit(rings[next(turn) % 2], K_icl, config=cfg_icl)
    for _ in range(4):                  # the eager first call, the recording, replays
        call()
    torch.cuda.synchronize()
    calls = 10
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    out["icl_b64_frames_per_s"] = 64 * calls / (time.perf_counter() - t0)
    out["icl_b64_pool_bytes"] = depth_batch_graph((64, *icl.shape), cfg_icl, dev).pool_bytes
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkouts", type=lambda v: [pathlib.Path(x) for x in v.split(",")],
                    required=True, metavar="DIR,DIR")
    ap.add_argument("--rounds", type=int, default=2,
                    help="passes over the checkouts, every other one in reverse order")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a turn may take")
    args = ap.parse_args(argv)
    import torch

    from deplex_tpu_torch.tools._common import checkout_turns, run_in_checkout

    if not torch.cuda.is_available():
        print("tree_ab: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    turns = []
    for i, checkout in enumerate(checkout_turns(args.checkouts, args.rounds)):
        if not (checkout / "deplex_tpu_torch").is_dir():
            raise SystemExit(f"tree_ab: {checkout.resolve()} holds no deplex_tpu_torch")
        run = run_in_checkout(checkout, __file__, [_MEASURE], args.timeout)
        if run.pop("returncode") != 0:
            raise SystemExit(f"tree_ab: turn {i} ({checkout}) failed:\n{run.get('stderr')}")
        row = {"turn": i, "checkout": str(checkout), **run}
        turns.append(row)
        print(f"[tree_ab] turn={i} checkout={checkout} "
              + " ".join(f"{k}={json.dumps(v)}" for k, v in row.items()
                         if k not in ("turn", "checkout", "package")) + f" gpu={gpu!r}",
              flush=True)
    print(json.dumps({"gpu": gpu, "turns": turns}))
    return 0


if __name__ == "__main__":
    if _MEASURE in sys.argv:
        sys.path.pop(0)                 # this file's directory: import from PYTHONPATH only
        print(json.dumps(measure()))
        sys.exit(0)
    sys.exit(main())
