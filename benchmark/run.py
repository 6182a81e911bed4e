"""Run one cell of BENCHMARK.json once and print its result line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for (without them it exits 2 and prints no result). The port's kernel
library builds on the first run in a checkout, into the checkout's
``build/deplex_tpu_torch/``, and later runs load it from there.
"""

import time

T0 = time.perf_counter()             # set-up is counted from here

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Every cache a library of the program could keep lives at a fixed path in
# the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
sys.path[0] = str(ROOT)              # the checkout, not benchmark/, is the import root

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
