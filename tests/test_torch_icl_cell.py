"""The benchmark's ICL-NUIM living-room deployment (``benchmark/configs/icl_p4.json``:
deplex's ICL ini, 4-pixel cells, 120 x 160 a frame) through the port's batch
entry on the CPU twins: its labels equal the benchmark's plain reference
pixel for pixel on seeded rolls of the frame, and keep the golden F1. The
stage-3 counters (``profiling.counters``) count its frames, their rounds,
its radix-staged frames and the frames whose rounds run one row a lane, as
the kernel would."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import frames
from benchmark.reference import stages
from benchmark.reference.config import Config as ReferenceConfig
from deplex_tpu_torch import profiling
from deplex_tpu_torch.config import Config
from deplex_tpu_torch.kernels import growing
from deplex_tpu_torch.parallel.batch import extract_depth_batch
from deplex_tpu_torch.pipeline import compute_cells

from .conftest import DATA, label_f1, load_golden

CONFIGS = DATA.parent / "benchmark" / "configs"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def deployment(name: str):
    """(configuration file, bundled frame (H, W) uint16, 3x3 float32 K)."""
    conf = json.loads((CONFIGS / f"{name}.json").read_text())
    frame = frames.read_png16(DATA.parent / conf["frame"])
    K = torch.tensor(conf["intrinsics"], dtype=torch.float32).reshape(3, 3)
    return conf, frame, K


def test_icl_batch_equals_the_reference_on_seeded_rolls():
    conf, frame, K = deployment("icl_p4")
    ring = frames.rolled_ring(frame, 2, 2 ** 31 + 12345, "cpu")
    got = extract_depth_batch(ring, K, Config.from_dict(conf["parameters"]))
    ref = stages.labels(ring, K, ReferenceConfig.from_dict(conf["parameters"]), torch.int32)
    assert got.shape == ref.shape == (2, 480 * 640)
    assert int((got != ref).sum()) == 0
    assert int(got.max()) > 0


def test_icl_unrolled_frame_keeps_the_golden_f1():
    conf, frame, K = deployment("icl_p4")
    depth = torch.from_numpy(frame.view(np.int16)).view(torch.uint16)[None]
    got = extract_depth_batch(depth, K, Config.from_dict(conf["parameters"]))[0].numpy()
    f1, p, r = label_f1(got, load_golden("icl_ini_labels"))
    assert f1 >= 0.95, (f1, p, r)


@pytest.mark.parametrize("name,radix", [("icl_p4", True), ("tum_default", False)])
def test_counters_count_frames_rounds_and_radix_staging(name, radix):
    """ICL's 120 x 160 grid sorts by radix and runs its rounds one row a
    lane on four warps; TUM's 48 x 64 does neither."""
    conf, frame, K = deployment(name)
    cfg = Config.from_dict(conf["parameters"])
    ring = frames.rolled_ring(frame, 2, 99, "cpu")
    cells = compute_cells(ring, K, cfg)
    profiling.reset_counters()
    _, _, nr_rounds = growing.grow_rounds(cells, cfg)
    counts = profiling.counters()
    assert counts["frames"] == 2
    assert counts["rounds"] == int(nr_rounds.sum()) > 0
    assert counts["radix_frames"] == (2 if radix else 0)
    assert counts["multiwarp_frames"] == (2 if name == "icl_p4" else 0)


def test_reset_counters_zeroes_them():
    conf, frame, K = deployment("tum_default")
    cfg = Config.from_dict(conf["parameters"])
    growing.grow_rounds(compute_cells(frames.rolled_ring(frame, 1, 3, "cpu"), K, cfg), cfg)
    assert profiling.counters()["frames"] >= 1
    profiling.reset_counters()
    assert profiling.counters() == {"frames": 0, "rounds": 0, "radix_frames": 0,
                                    "multiwarp_frames": 0}


@pytest.mark.parametrize("gh,gw,fits", [(48, 64, True), (120, 160, True), (180, 320, False)])
def test_shared_memory_rule_of_the_staging(gh, gw, fits):
    """TUM's and ICL's grids fit in shared memory (ICL's in 212,480 of
    232,448 bytes); 720p at 4-pixel cells runs on the global workspace, so
    every frame of it sorts by radix."""
    assert growing.fits_shared(gh, gw, 400) is fits
    bins = torch.zeros((2, gh, gw), dtype=torch.int32)      # one bin: sorted by radix
    planar = torch.ones((2, gh, gw), dtype=torch.bool)
    assert growing.radix_staged(bins, planar, 400).tolist() == [True, True]
    spread = torch.arange(gh * gw, dtype=torch.int32).reshape(1, gh, gw).expand(2, -1, -1) % 400
    assert growing.radix_staged(spread.contiguous(), planar, 400).tolist() == [not fits] * 2


@pytest.mark.parametrize("gh,gw,rows", [(48, 64, False), (120, 160, True), (90, 160, True),
                                        (64, 64, False), (180, 320, False), (40, 300, False),
                                        (33, 160, True), (155, 129, True), (100, 40, False),
                                        (65, 65, False), (60, 256, False)])
def test_the_rule_of_the_row_band(gh, gw, rows):
    """The grids whose rounds run one row a lane on ceil(gh/32) warps: in
    shared memory (720p at 4-pixel cells, 180 x 320, is not) with rows of
    3 words, 129-192 columns: ICL's 120 x 160 and the 720p primitives'
    90 x 160 at 8-pixel cells. TUM's 48 x 64 and 64 x 64 keep the one-warp
    register band; rows of 1, 2, 4 or 5 words the memory band."""
    assert growing.fits_shared(gh, gw, 400) is ((gh, gw) != (180, 320))
    assert growing.multiwarp(gh, gw, 400) is rows
