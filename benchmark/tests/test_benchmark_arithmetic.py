"""The benchmark's arithmetic: the trace's busy and idle time, the gaps and
what the host did in them, the per-layer readers on synthetic traces, the
byte and operation counts against the port's measurement tool, the seeded
inputs and the seeded sample."""

import numpy as np
import pytest
import torch

from benchmark import costs, frames, harness, trace
from benchmark.drivers import Reservoir
from benchmark.reference import stages
from benchmark.trace import Op, Trace

ROOT = harness.ROOT


def _trace():
    """Two calls of 100 us each; the device busy 10-40 and 30-50 (union 40
    us) in the first, a copy at 130-160 in the second; the first call's
    launch put the two kernels on the device, the second's copy the copy."""
    device = [Op("k1", 10, 40, 7), Op("k2", 30, 50, 7),
              Op("Memcpy HtoD (Pinned -> Device)", 130, 160, 9)]
    host = [Op("cudaGraphLaunch", 50, 90, 7), Op("aten::copy_", 160, 200, 9),
            Op("aten::copy_", 20, 25)]
    calls = [Op(trace.CALL_SPAN, 0, 100), Op(trace.CALL_SPAN, 100, 200)]
    return Trace(device, host, calls, wall_us=250.0, n_calls=2)


def test_busy_is_the_union_of_the_intervals():
    tr = _trace()
    assert trace.busy_us(tr.device) == 70.0
    assert trace.busy_us([Op("a", 0, 10), Op("b", 2, 5), Op("c", 10, 12)]) == 12.0
    assert trace.busy_per_call_us(tr) == 35.0
    assert trace.busy_per_call_us(Trace([], [], [], 1.0, 1)) is None
    # 35 us a call, 20,000 calls in a second: 70% busy.
    assert trace.idle_pct(35.0, 20_000, 1.0) == pytest.approx(30.0)
    assert trace.idle_pct(None, 1, 1.0) is None and trace.idle_pct(35.0, 0, 1.0) is None


def test_gaps_and_what_the_host_did_in_them():
    tr = _trace()
    assert trace.gaps(tr.device) == [(50, 130)]
    # The gap's middle (90) lies inside the first call, where only the
    # launch (50-90) spans it.
    assert trace.idle_gaps(tr) == [["cudaGraphLaunch", 80 / 1e6 / 2]]
    tr.host = []
    assert trace.idle_gaps(tr) == [[trace.CALL_SPAN, 80 / 1e6 / 2]]
    tr.calls = []
    assert trace.idle_gaps(tr) == [["harness loop", 80 / 1e6 / 2]]


def test_device_ops_and_host_overhead():
    tr = _trace()
    assert trace.device_ops(tr)[0] == ["k1", 30 / 1e6 / 2]
    # Two operations launched in the first call, one in the second; with a
    # third call of two, the one short call moves no median.
    assert trace.ops_per_call(tr) == 1.5
    tr3 = Trace(tr.device, tr.host, tr.calls + [Op(trace.CALL_SPAN, 300, 400)], 400.0, 3)
    tr3.device = tr.device + [Op("k1", 310, 340, 11), Op("k2", 340, 350, 11)]
    tr3.host = tr.host + [Op("cudaGraphLaunch", 300, 320, 11)]
    assert trace.ops_per_call(tr3) == 2.0
    # The traced calls 1 and 2 (latencies 0.9 and 0.95 ms) are left out:
    # the median of 0.1, 0.2 and 0.4 ms, less 35 us busy a call.
    run = harness.Run(setup_s=1.0, window={"seconds": 1.0, "calls": 5, "frames": 5,
                                           "latencies_ms": [0.1, 0.9, 0.95, 0.2, 0.4]},
                      trace=tr, stretch=(1, 2, 0.002))
    assert run.untraced_latencies_ms() == [0.1, 0.2, 0.4]
    assert run.untraced() == (3, 0.998)
    assert harness.reader("host_overhead_ms.camera")(run) == pytest.approx(0.2 - 0.035)
    # 35 us busy over the three calls' mean latency of 0.7 / 3 ms.
    assert harness.reader("device_idle_pct.camera")(run) == pytest.approx(
        100 * (1 - 0.035 / (0.7 / 3)))


def test_the_readers_on_a_synthetic_trace():
    tr = _trace()
    run = harness.Run(setup_s=7.5, window={"seconds": 2.0, "calls": 10, "frames": 640,
                                           "latencies_ms": [1.0, 2.0, 3.0, 4.0]},
                      trace=tr, least_s=14e-6, stretch=(4, 2, 0.5))
    read = {m: harness.reader(m)(run) for m in (
        "setup_s", "frames_per_s", "latency_p50_ms", "latency_p95_ms",
        "device_idle_pct.resident", "device_ops_per_call.resident", "host_overhead_ms.camera",
        "call_roofline_pct.resident")}
    assert read["setup_s"] == 7.5
    assert read["frames_per_s"] == 320.0
    assert read["latency_p50_ms"] == 2.5 and read["latency_p95_ms"] == pytest.approx(3.85)
    assert read["device_ops_per_call.resident"] == 1.5
    # 35 us busy a call, 8 calls in the 1.5 s outside the traced stretch.
    assert read["device_idle_pct.resident"] == pytest.approx(100 * (1 - 35e-6 * 8 / 1.5))
    # 14 us of bounds a call over 35 us busy a call.
    assert read["call_roofline_pct.resident"] == pytest.approx(40.0)
    empty = harness.Run(setup_s=1.0, window={"seconds": 1.0, "calls": 0, "frames": 0})
    for m in ("frames_per_s", "latency_p50_ms", "device_idle_pct.camera",
              "call_roofline_pct.resident"):
        assert harness.reader(m)(empty) is None


def test_the_counts_equal_the_measurement_tools_at_tum_b64():
    """The copied byte counts read the same as kernel_bench's at TUM B=64,
    and the stages' bounds add up to 34.2 us a call."""
    from deplex_tpu_torch.config import Config
    from deplex_tpu_torch.tools import kernel_bench as kb

    cell = harness.resolve("tum_default.resident_b64")
    cfg, rcfg = cell.program_config(), cell.reference_config()
    B, H, W = 64, 480, 640
    depth = torch.zeros((B, H, W), dtype=torch.uint16)
    assert costs.moments_cost(depth, rcfg) == kb.moments_cost(depth, cfg)
    planes = torch.zeros((13, B, 48, 64))
    assert costs.cells_cost(planes[0].numel()) == kb.cells_cost(planes)
    grid = torch.zeros((B, 48, 64), dtype=torch.int32)
    assert costs.rounds_cost(grid, rcfg) == kb.rounds_cost(grid, cfg)
    assert costs.round_cost(grid, rcfg) == kb.round_cost(grid, cfg)
    merge = torch.zeros((B, 64), dtype=torch.int32)
    assert costs.labels_cost(grid, merge, H, W, 10, torch.uint8) == kb.labels_cost(
        grid, merge, H, W, 10, torch.uint8)
    rec = stages.Record()
    frame = frames.rolled_ring(cell.frame, 1, 0, "cpu")
    stages.labels(frame, torch.as_tensor(cell.intrinsics), rcfg, torch.uint8, rec)
    assert costs.merge_cost(rec.labels_map, rec.segments) == kb.merge_cost(rec.labels_map,
                                                                           rec.segments)
    big = stages.Record(depth=depth, planes=planes, bins=grid, round_map=grid,
                        labels_map=grid, merge_labels=merge,
                        segments=type(rec.segments)(*(t.expand(B, *t.shape[1:])
                                                      for t in rec.segments)))
    total = sum(costs.call_least_s(big, rcfg, torch.uint8).values())
    assert total * 1e6 == pytest.approx(34.18, abs=0.05)
    assert isinstance(cfg, Config)


def test_stage6_counts_equal_the_measurement_tools():
    """Sampling and chunk-step counts on the reference's own intermediates
    read the same as kernel_bench's on the same tensors."""
    from deplex_tpu_torch.tools import kernel_bench as kb

    cell = harness.resolve("tum_ransac.resident_b8")
    cfg, rcfg = cell.program_config(), cell.reference_config()
    rec = stages.Record()
    frame = frames.rolled_ring(cell.frame, 1, 3, "cpu")
    stages.labels(frame, torch.as_tensor(cell.intrinsics), rcfg, torch.uint8, rec)
    s = rec.sampled
    assert costs.sampling_cost(rec, 640, 10, rcfg) == kb.sampling_cost(
        rec.points, rec.labels_map, rec.merge_labels, 640, 10, cfg, s)
    case = {"cells": s.cells, "chunk": s.chunk, "hyp": s.hyp, "kw": {"patch_size": 10}}
    for done in rec.done_before:
        assert costs.chunk_cost(rec, done, 10) == kb.ransac_cost(case, done)
    least = costs.call_least_s(rec, rcfg, torch.uint8)
    assert set(least) == {"cell_moments", "cell_finalize", "grow_rounds", "round_finalize",
                          "merge_planes", "ransac_sampling", "ransac_scores", "pixel_labels"}


def test_inputs_and_sample_are_seeded():
    base = frames.read_png16(ROOT / "data/tum/1341848230.910894.png")
    a = frames.rolled_ring(base, 6, 2 ** 31 + 11, "cpu")
    b = frames.rolled_ring(base, 6, 2 ** 31 + 11, "cpu")
    c = frames.rolled_ring(base, 6, 12, "cpu")
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert not torch.equal(a.view(torch.int16), c.view(torch.int16))
    assert frames.rolls(-5, 3).shape == (3, 2)
    assert frames.rolls(7, 50).min() >= 0 and frames.rolls(7, 50).max() <= 7

    def sample(seed):
        r = Reservoir(seed, 4)
        for i in range(1000):
            r.offer(i, i)
        return [i for i, _ in r.items()]
    assert sample(9) == sample(9) and sample(9) != sample(10) and len(sample(9)) == 4
    counts = np.zeros(10)
    for seed in range(400):
        for i in sample(seed):
            counts[i // 100] += 1
    assert counts.min() > 0.6 * counts.mean()    # uniform over the window's calls


def test_the_decoder_is_the_ports(tmp_path):
    from deplex_tpu_torch.utils.depth_image import decode_png16, encode_png16

    path = ROOT / "data/tum/1341848230.910894.png"
    assert np.array_equal(frames.read_png16(path), decode_png16(path.read_bytes()))
    img = np.random.default_rng(0).integers(0, 65535, (6, 9), dtype=np.uint16)
    for f in range(5):
        png = tmp_path / f"filter{f}.png"
        png.write_bytes(encode_png16(img, filter_type=f))
        assert np.array_equal(frames.read_png16(png), img)
