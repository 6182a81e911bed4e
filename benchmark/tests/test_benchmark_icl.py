"""The ICL-NUIM living-room deployment (``icl_p4``) and its cell
``icl_p4.resident_b64``: the configuration is the shipped ini and camera in
both the port and the reference, the cell finds its files by name and runs
(on the CPU, at one frame a call), and ``k2_ns_per_round.resident`` reads
K2's time a round from a trace and the program's counters, or nothing."""

import json
import shutil

import numpy as np
import pytest
import torch

from benchmark import harness, trace
from benchmark.trace import Op, Trace

ROOT = harness.ROOT
CELL = "icl_p4.resident_b64"
READER = "k2_ns_per_round.resident"


def test_parameters_are_the_shipped_ini_in_the_port_and_the_reference():
    from deplex_tpu_torch.config import Config

    from benchmark.reference.config import Config as ReferenceConfig

    conf = json.loads((ROOT / "benchmark/configs/icl_p4.json").read_text())
    shipped = Config.from_ini(str(ROOT / "data/configs/ICL_living_room.ini"))
    assert len(conf["parameters"]) == 16
    assert Config.from_dict(conf["parameters"]) == shipped
    assert ReferenceConfig.from_dict(conf["parameters"]).__dict__ == shipped.__dict__
    assert conf["reduced"] == []


def test_intrinsics_are_the_shipped_camera():
    conf = json.loads((ROOT / "benchmark/configs/icl_p4.json").read_text())
    K = np.loadtxt(ROOT / "data/configs/ICL_living_room.K", dtype=np.float32)
    assert np.array_equal(np.asarray(conf["intrinsics"], np.float32).reshape(3, 3), K)
    assert K[1, 1] < 0                     # the ICL camera's y axis points up


def test_the_cell_resolves_to_its_files():
    cell = harness.resolve(CELL)
    assert cell.frame.shape == (cell.height, cell.width) == (480, 640)
    assert cell.traffic == json.loads((ROOT / "benchmark/traffic/resident_b64.json").read_text())
    assert harness.driver_class(cell).__module__ == "benchmark.drivers.resident"
    P = cell.program_config().patch_size
    assert P == cell.reference_config().patch_size == 4
    assert (cell.height // P) * (cell.width // P) == 19200
    assert [m["name"] for m in cell.metrics("end_to_end")] == ["frames_per_s", "setup_s"]
    assert {m["name"] for m in cell.metrics("per_layer")} == {
        "device_idle_pct.resident", "device_ops_per_call.resident",
        "call_roofline_pct.resident", "entry_host_ms.resident", READER}
    for m in cell.metrics("end_to_end") + cell.metrics("per_layer"):
        assert callable(harness.reader(m["name"]))


def test_the_cell_runs_and_is_judged_at_one_frame_a_call(tmp_path):
    """The cell's configuration under a one-frame mix of the same driver, on
    the CPU: the port's labels equal the reference's."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "data").symlink_to(ROOT / "data")
    (root / "benchmark/traffic/resident_b1.json").write_text(json.dumps(
        {"driver": "resident", "batch": 1, "ring_batches": 2, "sample_calls": 2,
         "trace_calls": 2}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "icl_p4.resident_b1", "config": "icl_p4",
                              "traffic": "resident_b1", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve("icl_p4.resident_b1", root=root)
    out = harness.run(cell, 2 ** 33 + 1, 0.1, False, torch.device("cpu"), 0.0, root=root,
                      log=lambda *a: None)
    assert out["correct"] is True
    assert out["compared"]["mismatched_px"]["value"] == 0
    assert out["compared"]["frames_judged"]["value"] >= 1


def _run(k2_us=(900.0, 880.0)) -> harness.Run:
    """Two traced calls, each with a K2 launch of k2_us and other kernels."""
    device, calls = [], []
    for i, us in enumerate(k2_us):
        t0 = 2000.0 * i
        device += [Op("void (anonymous namespace)::cell_moments_band<4>", t0, t0 + 80),
                   Op("void (anonymous namespace)::grow_rounds_kernel<true, 0>", t0 + 100,
                      t0 + 100 + us),
                   Op("round_finalize_kernel", t0 + 100 + us, t0 + 220 + us)]
        calls.append(Op(trace.CALL_SPAN, t0, t0 + 1500))
    tr = Trace(device, [], calls, wall_us=4000.0, n_calls=len(calls))
    return harness.Run(setup_s=1.0, window={"seconds": 1.0, "calls": 9, "frames": 576},
                       trace=tr, stretch=(3, 2, 0.004))


def test_k2_ns_per_round_is_k2s_time_a_call_over_the_rounds_a_frame(monkeypatch):
    from deplex_tpu_torch import profiling

    monkeypatch.setattr(profiling, "counters",
                        lambda: {"frames": 640, "rounds": 640 * 66, "radix_frames": 640})
    # (900 + 880) / 2 us a call over 66 rounds a frame.
    assert harness.reader(READER)(_run()) == pytest.approx(890e3 / 66)


def test_k2_ns_per_round_reads_nothing_where_there_is_nothing(monkeypatch):
    from deplex_tpu_torch import profiling

    read = harness.reader(READER)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"frames": 64, "rounds": 5000, "radix_frames": 0})
    assert read(harness.Run(setup_s=1.0, window={"seconds": 1.0, "calls": 1,
                                                  "frames": 64})) is None
    no_k2 = _run()
    no_k2.trace.device = [o for o in no_k2.trace.device if "grow_rounds" not in o.name]
    assert read(no_k2) is None
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"frames": 0, "rounds": 0, "radix_frames": 0})
    assert read(_run()) is None
    # A program without the counters (an older tree) gives no reading.
    monkeypatch.delattr(profiling, "counters")
    assert read(_run()) is None
