"""The control of ``correct``: a cell run with the stand-in of the cell's
judge in the program's place (``in_place_of_program``: the reference one
precision below the configuration's; for plane labels, in TF32), judged as
every run is. Its compared numbers are the upper readings the limits are
set below; it must come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--seconds 3]

runs the cell once a seed on the card (one process, the reference's
first-call costs paid once) and prints a JSON line a seed. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def control_run(cell, seed: int, seconds: float, device, log=print,
                root: pathlib.Path = harness.ROOT) -> dict:
    with cell.judge.in_place_of_program(cell, device):
        return harness.run(cell, seed, seconds, False, device, time.perf_counter(), root=root,
                           log=log)


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
