"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the judgement of the window's outputs against the plain reference, and the
result line.

Everything a cell needs is found by name: the workload's ``config`` entry
names its file under ``benchmark/configs/``, its ``traffic`` names
``benchmark/traffic/<traffic>.json``, whose ``driver`` names
``benchmark/drivers/<driver>.py``, the configuration's ``judge`` (``labels``
without the key) names ``benchmark/judges/<judge>.py``, which decides
``correct`` (``benchmark.judge``), and each metric ``<name>`` of
``BENCHMARK.json`` is read by ``benchmark/metrics/<name>.py`` (its
``read(run)`` returns the value, or None where the run holds nothing to
read). A cell reports the metrics whose ``workloads`` list it, or that have
no such list: with ``--trace 0`` the end-to-end ones, with ``--trace 1``
the per-layer ones, read from a profile of a stretch of the window's calls.
The interpreter's garbage collector is off in the window (``collector_off``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import frames, judge
from benchmark.drivers import Window

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# Whole top-level module names that must not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "deplex_tpu")


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration and mix."""
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the mix's file
    frame: np.ndarray     # the configuration's depth frame, (H, W) uint16
    spec: dict            # BENCHMARK.json
    judge: object         # the configuration's judge module (benchmark.judge)

    @property
    def height(self) -> int:
        return int(self.config["image_height"])

    @property
    def width(self) -> int:
        return int(self.config["image_width"])

    @property
    def intrinsics(self) -> np.ndarray:
        """The 3x3 float32 intrinsics (the file's nine numbers, row by row)."""
        return np.asarray(self.config["intrinsics"], np.float32).reshape(3, 3)

    def program_config(self):
        from deplex_tpu_torch.config import Config

        return Config.from_dict(self.config["parameters"])

    def reference_config(self):
        from benchmark.reference.config import Config

        return Config.from_dict(self.config["parameters"])

    def metrics(self, kind: str) -> list[dict]:
        """The metrics of `kind` ("end_to_end" or "per_layer") this cell reports."""
        return [m for m in self.spec[kind] if self.name in m.get("workloads", [self.name])]


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def resolve(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell `name` of root's BENCHMARK.json, its files read by name."""
    spec = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    frame = frames.read_png16(root / config["frame"])
    if frame.shape != (int(config["image_height"]), int(config["image_width"])):
        raise SystemExit(f"{config['frame']}: {frame.shape}, not the configuration's size")
    return Cell(name, int(w["chips"]), config, traffic, frame, spec, judge_module(config, root))


def load_module(path: pathlib.Path, name: str):
    """A module of the benchmark's own by its file's path (metric names hold
    dots, so they are not import paths)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(cell: Cell, root: pathlib.Path = ROOT):
    kind = cell.traffic["driver"]
    return load_module(root / "benchmark" / "drivers" / f"{kind}.py",
                       f"benchmark.drivers.{kind}").Driver


def judge_module(config: dict, root: pathlib.Path = ROOT):
    """The module of the judge the configuration names (benchmark.judge)."""
    kind = config.get("judge", judge.DEFAULT)
    path = root / "benchmark" / "judges" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"no judge {kind!r}: {path} does not exist")
    return load_module(path, f"benchmark.judges.{kind}")


def reader(name: str, root: pathlib.Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_")).read


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""
    setup_s: float
    window: dict                 # the driver's: seconds, calls, frames, ...
    trace: object = None         # benchmark.trace.Trace of the profiled stretch
    least_s: float | None = None   # the configured stages' least seconds a call
    stretch: tuple | None = None   # the profiled (first call, calls, seconds)

    def untraced(self) -> tuple[int, float]:
        """The window's calls and seconds outside the profiled stretch."""
        first, calls, seconds = self.stretch or (0, 0, 0.0)
        return self.window["calls"] - calls, self.window["seconds"] - seconds

    def untraced_latencies_ms(self) -> list[float]:
        """The camera's latencies of the calls outside the profiled stretch."""
        lat = self.window.get("latencies_ms") or []
        first, calls, _ = self.stretch or (0, 0, 0.0)
        return lat[:first] + lat[first + calls:]


@contextlib.contextmanager
def collector_off():
    """The interpreter's garbage collector off, with what set-up left
    frozen: the harness's own bookkeeping in the window (the camera's event
    pairs, the sample) then starts no collection inside a call."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


class Forbidden(Exception):
    """A module of JAX or of the JAX package got loaded in the run's process."""


def check_forbidden() -> None:
    loaded = forbidden_modules()
    if loaded:
        raise Forbidden(f"loaded in the run's process: {', '.join(loaded)}")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.splitlines()
        index = device.index or 0
        if index < len(out):
            return out[index].strip()
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float, root: pathlib.Path = ROOT, log=print) -> dict:
    """One run of `cell`; `t0` is the process's start on the host clock.
    Returns the result line's object."""
    from deplex_tpu_torch import compiled

    from benchmark import trace as tracing

    card = device.type == "cuda"
    t_setup = time.perf_counter()
    driver = driver_class(cell, root)(cell, seed, device)
    driver.setup()
    t_driver = time.perf_counter()
    if trace and card:
        tracing.Profile.warm()
    profile = tracing.Profile() if trace and card else None
    w = Window(seconds, device, profile, driver.trace_calls)
    setup_s = time.perf_counter() - t0
    log(f"[setup] to_driver_s={t_setup - t0} driver_s={t_driver - t_setup} "
        f"profiler_s={setup_s - (t_driver - t0)}")
    with collector_off():
        window = driver.window(w)
    check_forbidden()
    peak = torch.cuda.max_memory_allocated(device) if card else 0
    pool = compiled.pool_bytes(device) if card else 0
    log(f"[memory] peak_bytes={peak} graph_pool_bytes={pool}")
    log(f"[window] seconds={window['seconds']} calls={window['calls']} "
        f"frames={window['frames']} setup_s={setup_s}")
    samples = driver.judged()
    driver.close()
    compiled.clear()
    if card:
        torch.cuda.empty_cache()
    verdict = cell.judge.judge(samples, cell, device, records=trace)
    r = Run(setup_s, window, w.trace, verdict.least_s, w.stretch)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = reader(m["name"], root)(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if card else "cpu",
           "kind": torch.cuda.get_device_name(device) if card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": verdict.correct, "attempted": window["frames"],
           "failed": verdict.failed, "metrics": metrics, "device": dev}
    if trace and w.trace is not None:
        dev["busy_s"] = tracing.busy_us(w.trace.device) / 1e6
        dev["window_s"] = w.trace.wall_us / 1e6
        out["breakdown"] = {"device_ops": tracing.device_ops(w.trace),
                            "idle_gaps": tracing.idle_gaps(w.trace)}
    out["compared"] = verdict.compared
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(args.workload)
    import deplex_tpu_torch

    if ROOT not in pathlib.Path(deplex_tpu_torch.__file__).resolve().parents:
        print(f"deplex_tpu_torch is not this checkout's: {deplex_tpu_torch.__file__}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_imported = time.perf_counter()
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    print(f"[card] {card_line(device)}; imports_s={t_imported - t0} "
          f"context_s={time.perf_counter() - t_imported}", flush=True)
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace), device, t0)
        check_forbidden()
    except Forbidden as e:
        print(f"{args.workload}: {e}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']} limit {c['rule']} {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
