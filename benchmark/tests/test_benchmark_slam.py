"""The SLAM frame-step cell, ``slam_tum.process_frame``: found by name, its
driver and judge run a short window on the CPU and come out correct, the
judge refuses a flipped match, a pose moved by 10x a limit, a plane moved
by 10x a limit and a slot emptied, the control
comes out not correct, and its readers on synthetic traces."""

import json

import pytest
import torch

from benchmark import control, harness, trace
from benchmark.drivers import Window
from benchmark.judges import slam as slam_judge
from benchmark.reference import slam as reference
from benchmark.tests.test_benchmark_spec import _copy_tree
from benchmark.trace import Op, Trace

CELL = "slam_tum.process_frame"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
READERS = ("device_idle_pct.slam", "device_ops_per_call.slam", "tracking_device_us.slam",
           "slam_host_ms.slam", "host_reads_per_frame.slam")


def test_the_cell_resolves_to_its_configuration_mix_driver_judge_and_readers():
    cell = harness.resolve(CELL)
    assert cell.config["judge"] == "slam"
    assert cell.judge.__file__ == str(harness.ROOT / "benchmark/judges/slam.py")
    assert harness.driver_class(cell).__module__ == "benchmark.drivers.slam"
    assert cell.config["slam"] == {"max_landmarks": 128, "odom_iterations": 8,
                                   "min_obs_weight": 0.0, "episode_frames": 30}
    tum = json.loads((harness.ROOT / "benchmark/configs/tum_default.json").read_text())
    for key in ("frame", "image_height", "image_width", "intrinsics", "parameters"):
        assert cell.config[key] == tum[key]
    assert cell.traffic == {**cell.traffic, "driver": "slam", "sequences": 4,
                            "sample_episodes": 4, "trace_calls": 300}
    assert [m["name"] for m in cell.metrics("end_to_end")] == [
        "latency_p50_ms", "latency_p95_ms", "setup_s"]
    assert [m["name"] for m in cell.metrics("per_layer")] == list(READERS)
    for m in cell.metrics("per_layer"):
        assert m["moves"] == "latency_p50_ms" and m["workloads"] == [CELL]
        assert callable(harness.reader(m["name"]))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads from the module's first fixture on: the suite runs in
    several processes, and a CPU step slows many times over when their
    threads outnumber the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of the tree whose SLAM cell tracks 3-frame sessions of two
    sequences of the frame's central 240 x 320 pixels, K's principal point
    moved with them (the CPU's size); the cell resolved there."""
    from deplex_tpu_torch.utils.depth_image import write_png16

    root = _copy_tree(tmp_path_factory.mktemp("slam"))
    path = root / "benchmark/configs/slam_tum.json"
    conf = json.loads(path.read_text())
    frame = harness.resolve(CELL).frame
    write_png16(root / "crop.png", frame[120:360, 160:480])
    K = list(conf["intrinsics"])
    K[2], K[5] = K[2] - 160, K[5] - 120
    conf.update(frame="crop.png", image_height=240, image_width=320, intrinsics=K)
    conf["slam"]["episode_frames"] = 3
    path.write_text(json.dumps(conf))
    path = root / "benchmark/traffic/process_frame.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), sequences=2,
                                    sample_episodes=2)))
    return root, harness.resolve(CELL, root=root)


@pytest.fixture(scope="module")
def sessions(small):
    """The judged sessions of a 3-s window of the driver on the CPU."""
    root, cell = small
    driver = harness.driver_class(cell, root)(cell, SEED, CPU)
    driver.setup()
    window = driver.window(Window(3.0, CPU))
    assert window["calls"] >= 3 and len(window["latencies_ms"]) == window["calls"]
    return driver.judged()


def test_a_run_of_the_cell_on_the_cpu_is_correct(small):
    root, cell = small
    out = harness.run(cell, SEED, 3.0, False, CPU, 0.0, root=root, log=lambda *a: None)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    c = out["compared"]
    assert c["frames_judged"]["value"] >= 3 and c["frames_judged"]["limit"] == 3
    assert c["mismatched_matches"]["value"] == 0 and c["map_count_mismatched"]["value"] == 0
    assert c["plane_slots_mismatched"]["value"] == 0
    for name in ("normal_err_max", "offset_err_mm_max", "mean_err_mm_max"):
        assert c[name]["value"] <= c[name]["limit"]
    assert c["rot_err_max"]["value"] <= slam_judge.ROT_LIMIT_RAD
    assert c["trans_err_mm_max"]["value"] <= slam_judge.TRANS_LIMIT_MM


def test_every_judged_session_is_whole_and_tracks(sessions):
    assert sessions
    for key, depth, results, count in sessions:
        assert key in (0, 1) and len(depth) == len(results) == 3
        assert int(results[0].num_matched) == 0
        assert all(int(r.num_matched) > 0 for r in results[1:])
        assert int(count) == sum(int(r.num_new) for r in results)


def _altered(sessions, how: str) -> list:
    """The sessions with frame 1 of the first one altered."""
    key, depth, results, count = sessions[0]
    r = results[1]
    if how == "match":
        lm = r.matches_lm.clone()
        slot = int(torch.nonzero(lm >= 0)[0, 0])
        lm[slot] = -1
        r = r._replace(matches_lm=lm)
    elif how in ("normal", "offset", "slot"):
        slot = int(torch.nonzero(r.obs.weight > 0)[0, 0])
        obs = r.obs
        if how == "normal":
            n = obs.normal.clone()
            n[slot, 0] += 10 * slam_judge.NORMAL_LIMIT
            obs = obs._replace(normal=n)
        elif how == "offset":
            d = obs.d.clone()
            d[slot] += 10 * slam_judge.OFFSET_LIMIT_MM
            obs = obs._replace(d=d)
        else:
            w = obs.weight.clone()
            w[slot] = 0.0
            obs = obs._replace(weight=w)
        r = r._replace(obs=obs)
    elif how == "rotation":
        phi = torch.tensor([0.0, 0.0, 10 * slam_judge.ROT_LIMIT_RAD])
        r = r._replace(R=reference.so3_exp(phi) @ r.R)
    else:
        r = r._replace(t=r.t + torch.tensor([10 * slam_judge.TRANS_LIMIT_MM, 0.0, 0.0]))
    return [(key, depth, [results[0], r, *results[2:]], count), *sessions[1:]]


def test_the_judge_passes_the_sessions_as_tracked(small, sessions):
    v = slam_judge.judge(sessions, small[1], CPU)
    assert v.correct and v.failed == 0


@pytest.mark.parametrize("how,name", [("match", "mismatched_matches"),
                                      ("rotation", "rot_err_max"),
                                      ("translation", "trans_err_mm_max"),
                                      ("normal", "normal_err_max"),
                                      ("offset", "offset_err_mm_max"),
                                      ("slot", "plane_slots_mismatched")])
def test_the_judge_refuses_a_flipped_match_or_a_pose_moved_by_10x_its_limit(small, sessions,
                                                                            how, name):
    v = slam_judge.judge(_altered(sessions, how), small[1], CPU)
    assert v.correct is False and v.failed >= 1
    c = v.compared[name]
    assert c["value"] > c["limit"]
    if how not in ("match", "slot"):
        assert c["value"] == pytest.approx(10 * c["limit"], rel=0.05)


def test_the_control_is_not_correct_and_restores_the_method(small):
    from deplex_tpu_torch import PlaneSlam

    original = PlaneSlam.process_frame
    root, cell = small
    out = control.control_run(cell, SEED, 3.0, CPU, log=lambda *a: None, root=root)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["compared"]["frames_judged"]["value"] >= 3
    assert PlaneSlam.process_frame is original


# --- the readers on synthetic traces ----------------------------------------------


def _call(t0: float) -> tuple[list, list]:
    """One process_frame call from t0 (us): the depth's upload 10-40 (its
    copy on the card 20-30), backproject 45-60, the step's span 60-300 (the
    graph's launch at 200, its plane kernels 210-500 and tracking kernels
    500-700), the download 310-800, whose first copy returns on the host at
    790 (the card ran it from 720) and the last ends at 760 on the card."""
    o = lambda name, s, e, corr=0: Op(name, t0 + s, t0 + e, corr)  # noqa: E731
    c = int(t0)
    host = [o("io.upload", 10, 40), o("cudaMemcpyAsync", 15, 35, c + 1),
            o("aten::stack", 45, 60, c + 4), o("cudaLaunchKernel", 46, 59, c + 4),
            o("slam.step", 60, 300), o("cudaGraphLaunch", 200, 260, c + 2),
            o("slam.download", 310, 800), o("cudaMemcpyAsync", 320, 790, c + 3),
            o("cudaMemcpyAsync", 791, 795, c + 5)]
    device = [o("Memcpy HtoD (Pageable -> Device)", 20, 30, c + 1),
              o("CatArrayBatchedCopy", 50, 58, c + 4),
              o("grow_rounds_kernel<true, 2>", 210, 400, c + 2),
              o("merge_warp_kernel", 400, 500, c + 2),
              o("gemv_kernel", 500, 700, c + 2),
              o("Memcpy DtoH (Device -> Pageable)", 720, 740, c + 3),
              o("Memcpy DtoH (Device -> Pageable)", 750, 760, c + 5)]
    return host, device


def _run(n: int = 3, drop=lambda op: False, counters=None) -> harness.Run:
    host, device, calls = [], [], []
    for i in range(n):
        h, d = _call(1000.0 * i)
        host += h
        device += d
        calls.append(Op(trace.CALL_SPAN, 1000.0 * i, 1000.0 * i + 900))
    tr = Trace([o for o in device if not drop(o)], [o for o in host if not drop(o)], calls,
               wall_us=1000.0 * n, n_calls=n)
    lat = [1.0] * 10
    return harness.Run(setup_s=1.0, window={"seconds": 1.0, "calls": 10, "frames": 10,
                                            "latencies_ms": lat},
                       trace=tr, stretch=(3, n, 0.003))


def read(name, run):
    return harness.reader(name)(run)


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    from deplex_tpu_torch import profiling

    run = _run()
    # Upload 30 us, the download from its first copy's return at 790 to 800.
    assert read("slam_host_ms.slam", run) == pytest.approx(0.040)
    # Busy 10 + 8 + 190 + 100 + 200 + 20 + 10 = 538 us a call; 290 of them
    # are the plane kernels.
    assert read("tracking_device_us.slam", run) == pytest.approx(248.0)
    assert read("device_idle_pct.slam", run) == pytest.approx(100 * (1 - 0.538))
    assert read("device_ops_per_call.slam", run) == 7.0
    monkeypatch.setattr(profiling, "slam_counters", lambda: {
        "slam_frames": 10, "slam_matched": 200, "slam_host_reads": 60})
    assert read("host_reads_per_frame.slam", run) == 6.0


def test_the_readers_are_none_without_what_they_read(monkeypatch):
    from deplex_tpu_torch import profiling

    parent = _run(drop=lambda op: op.name in ("io.upload", "slam.download", "slam.step"))
    assert read("slam_host_ms.slam", parent) is None
    empty = harness.Run(setup_s=1.0, window={"seconds": 1.0, "calls": 0, "frames": 0})
    for name in READERS[:4]:
        assert read(name, empty) is None
    monkeypatch.delattr(profiling, "slam_counters")
    assert read("host_reads_per_frame.slam", parent) is None
    monkeypatch.setattr(profiling, "slam_counters", lambda: {
        "slam_frames": 0, "slam_matched": 0, "slam_host_reads": 0}, raising=False)
    assert read("host_reads_per_frame.slam", parent) is None
