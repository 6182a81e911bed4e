"""The control of ``correct``: a cell run with the reference in TF32 in the
program's place, judged as every run is, against the reference in float32.
Its ``mismatched_px`` is the upper reading the limit is set below; it must
come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--seconds 3]

runs the cell once a seed on the card (one process, the reference's
first-call costs paid once) and prints a JSON line a seed. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import precision, stages  # noqa: E402


def _tf32_labels(cell, depth: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    K = torch.as_tensor(cell.intrinsics, device=device)
    with precision.tf32():
        return stages.labels(depth.to(device), K, cell.reference_config(), dtype)


def _depth(d, device) -> torch.Tensor:
    if isinstance(d, torch.Tensor):
        return d.to(device)
    arr = np.ascontiguousarray(d)
    return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.uint16)


@contextlib.contextmanager
def in_place_of_program(cell, device):
    """The program's entry of the cell's driver replaced by the reference in
    TF32, with the entry's signature and output."""
    from deplex_tpu_torch import PlaneExtractor
    from deplex_tpu_torch.parallel import batch

    def depth_batch(depth, intrinsics, *, config):
        return _tf32_labels(cell, depth, torch.uint8, depth.device)

    def process_depth(self, depth, intrinsics):
        return _tf32_labels(cell, _depth(depth, device)[None], torch.int32, device)[0].cpu().numpy()

    saved = (batch.extract_depth_batch_jit, PlaneExtractor.process_depth)
    batch.extract_depth_batch_jit = depth_batch
    PlaneExtractor.process_depth = process_depth
    try:
        yield
    finally:
        batch.extract_depth_batch_jit, PlaneExtractor.process_depth = saved


def control_run(cell, seed: int, seconds: float, device, log=print) -> dict:
    with in_place_of_program(cell, device):
        return harness.run(cell, seed, seconds, False, device, time.perf_counter(), log=log)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.resolve(args.workload)
        out = control_run(cell, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "compared": out["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
