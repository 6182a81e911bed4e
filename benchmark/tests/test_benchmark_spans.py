"""The readers of the program's host spans (``entry``, ``io.upload``,
``io.download``) on synthetic traces: each reader's value, None where the
spans are absent (a program without them), the download split at its
copy's start on the card, and a download whose copy is not matched."""

import pytest

from benchmark import harness, trace
from benchmark.trace import Op, Trace

READERS = ("entry_host_ms.camera", "entry_host_ms.resident", "io_host_ms.camera")


def _call(t0: float, entry_us: float) -> tuple[list, list]:
    """One camera call from t0 (us): the device's host ops and the card's.
    The depth's upload 10-40 (its copy on the card 20-30), K's 45-50, the
    entry from 60 for `entry_us` (the graph's launch at 200, its kernels
    210-700), the download 310-800, whose copy runs on the card from 720.
    The download's aten::copy_ carries a correlation id that the launch's
    also has: only a runtime call's id counts."""
    o = lambda name, s, e, corr=0: Op(name, t0 + s, t0 + e, corr)  # noqa: E731
    c = int(t0)
    host = [o("io.upload", 10, 40), o("cudaMemcpyAsync", 15, 35, c + 1),
            o("io.upload", 45, 50),
            o("entry", 60, 60 + entry_us), o("entry.key", 60, 80), o("entry.replay", 190, 270),
            o("cudaGraphLaunch", 200, 260, c + 2),
            o("io.download", 310, 800), o("aten::copy_", 315, 795, c + 2),
            o("cudaMemcpyAsync", 320, 790, c + 3), o("cudaStreamSynchronize", 791, 795)]
    device = [o("Memcpy HtoD (Pageable -> Device)", 20, 30, c + 1),
              o("grow_rounds_kernel", 210, 500, c + 2), o("pixel_labels_kernel", 500, 700, c + 2),
              o("Memcpy DtoH (Device -> Pageable)", 720, 760, c + 3)]
    return host, device


def _run(entries=(240.0, 300.0, 280.0), drop=lambda op: False) -> harness.Run:
    """Calls of 1000 us each with these entry durations; `drop` takes
    operations out of the trace."""
    host, device, calls = [], [], []
    for i, entry_us in enumerate(entries):
        h, d = _call(1000.0 * i, entry_us)
        host += h
        device += d
        calls.append(Op(trace.CALL_SPAN, 1000.0 * i, 1000.0 * i + 900))
    tr = Trace([o for o in device if not drop(o)], [o for o in host if not drop(o)], calls,
               wall_us=1000.0 * len(entries), n_calls=len(entries))
    return harness.Run(setup_s=1.0, window={"seconds": 1.0, "calls": 9, "frames": 9},
                       trace=tr, stretch=(3, len(entries), 0.003))


def read(name, run):
    return harness.reader(name)(run)


def test_the_entry_readers_are_the_median_of_each_calls_entry_spans():
    run = _run()
    assert read("entry_host_ms.camera", run) == pytest.approx(0.280)
    assert read("entry_host_ms.resident", run) == pytest.approx(0.280)
    # Two entry spans in one call are summed: the first call's 240 + 90 us.
    run.trace.host.append(Op("entry", 850, 940))
    assert read("entry_host_ms.camera", run) == pytest.approx(0.300)


def test_the_io_reader_splits_the_download_at_its_copys_start():
    # Uploads 30 + 5 us, and the download from the copy's start at 720 to
    # its end at 800: the 410 us before it waited for the replay.
    assert read("io_host_ms.camera", _run()) == pytest.approx(0.115)


def test_the_readers_are_none_without_the_spans():
    spans = {"entry", "entry.key", "entry.replay", "io.upload", "io.download"}
    parent = _run(drop=lambda op: op.name in spans)
    for name in READERS:
        assert read(name, parent) is None
        assert read(name, harness.Run(setup_s=1.0, window={"seconds": 1.0, "calls": 0,
                                                           "frames": 0})) is None


def test_a_download_whose_copy_is_not_matched_is_left_out():
    unmatched = _run(drop=lambda op: op.name.startswith("Memcpy DtoH"))
    assert read("io_host_ms.camera", unmatched) is None
    assert read("entry_host_ms.camera", unmatched) == pytest.approx(0.280)
    # The first call's copy lost: the median of the other two calls, not a
    # guess for the first.
    one_lost = _run(drop=lambda op: op.name.startswith("Memcpy DtoH") and op.start < 1000)
    assert read("io_host_ms.camera", one_lost) == pytest.approx(0.115)
