"""The benchmark's ICL-NUIM living-room deployment (``benchmark/configs/icl_p4.json``:
deplex's ICL ini, 4-pixel cells, 120 x 160 a frame) through the port's batch
entry on the CPU twins: its labels equal the benchmark's plain reference
pixel for pixel on seeded rolls of the frame, and keep the golden F1. The
stage-3 counters (``profiling.counters``) count its frames, their rounds,
its radix-staged frames, the frames whose rounds run one row a lane and the
radix sorts' passes, as the kernel would; the rule of those passes on the
sort's stress frames; the staging's shared-memory rule on every grid."""

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
from deplex_tpu_torch.tools import kernel_bench as kb

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
    """ICL's 120 x 160 grid sorts by radix in 5 passes a frame (its keys
    differ in all four bytes, then its 400 bins in one) and runs its rounds
    one row a lane on four warps; TUM's 48 x 64 does neither."""
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
    assert counts["radix_passes"] == (10 if radix else 0)


# (kind, gh, gw, bins a coordinate, passes a frame): the key's bytes that the
# counted cells' keys differ in, then the bins' passes: one up to 512 bins
# where 16 counters a bin fit the planes' space (ICL's 17,280 bytes) or on
# the global workspace, else one a byte (48x64's 8,320 bytes; 529 bins);
# none for one bin after a key pass.
PASS_CASES = [
    ("all_bytes", 120, 160, 20, 5), ("special", 120, 160, 20, 5),
    ("one_bin_ties", 120, 160, 20, 3), ("one_byte", 120, 160, 20, 2),
    ("equal_keys", 120, 160, 20, 1), ("all_bytes", 48, 64, 20, 6),
    ("equal_keys", 48, 64, 20, 2), ("all_bytes", 120, 160, 1, 4), ("one_byte", 120, 160, 1, 1),
    ("equal_keys", 120, 160, 1, 1), ("all_bytes", 120, 160, 22, 5),
    ("all_bytes", 120, 160, 23, 6), ("one_bin_ties", 111, 192, 20, 3),
    ("all_bytes", 300, 250, 20, 5), ("all_bytes", 300, 250, 23, 6),
]


@pytest.mark.parametrize("kind,gh,gw,per,passes", PASS_CASES)
def test_radix_passes_of_the_sort_stress_frames(kind, gh, gw, per, passes):
    """The CPU's rule of the radix sort's passes (``radix_passes``), which
    chip_smoke.py holds the card's counters to on the same frames; the
    grow_rounds counters add it on the CPU too."""
    nb2 = per * per
    bins, mse, packed = (torch.from_numpy(a) for a in
                         kb.sort_stress_case(np.random.default_rng(gh + per), 2, gh, gw, nb2,
                                             kind))
    planar = (packed & 16) != 0
    assert growing.radix_staged(bins, planar, nb2).tolist() == [True, True]
    assert growing.radix_passes(bins, planar, mse, nb2).tolist() == [passes, passes]


def test_radix_passes_are_zero_without_a_radix_sort():
    """No pass where the staging ranks by comparisons (small bins) or no
    cell is counted."""
    bins, mse, packed = (torch.from_numpy(a) for a in
                         kb.random_rounds_case(np.random.default_rng(3), 2, 48, 64, nbins=60))
    planar = (packed & 16) != 0
    assert growing.radix_staged(bins, planar, 400).tolist() == [False, False]
    assert growing.radix_passes(bins, planar, mse, 400).tolist() == [0, 0]
    none = torch.zeros_like(planar)
    assert growing.radix_passes(bins, none, mse, 400).tolist() == [0, 0]


def _layout_total(gh: np.ndarray, gw: np.ndarray, nb2: int) -> np.ndarray:
    """csrc/growing.cu's compact Layout.total, written out: the bit planes
    (6 planes of ceil(gw/64) words a row) or the sort's floor of 256 x 16
    16-bit counters and 128 bytes of scratch, whichever is larger, then the
    bins' int32 counts, uint16 heads and ends, the cells' 4-byte keys and
    three uint16 arrays (bins, list, buffer), each 16-byte aligned."""
    def a16(x):
        return (x + 15) & ~15
    n = gh * gw
    planes = a16(6 * gh * ((gw + 63) // 64) * 8)
    sort = 256 * 16 * 2 + 32 * 4
    return np.where(planes < sort, a16(sort), planes) + a16(nb2 * 4) + 2 * a16(nb2 * 2) \
        + a16(n * 4) + 3 * a16(n * 2)


def test_fits_shared_is_the_layouts_rule_on_every_grid():
    """Every grid of up to 65,535 cells at 400 bins: the
    staging fits in shared memory exactly where the compact layout does
    (227 KB), so the radix sort's counters, one-pass bin counters and rank
    bitmaps move no grid to the global workspace. ICL's 120 x 160 leaves
    the bitmaps' 2 KB; 111 x 192 leaves 144 bytes (its sort ranks with
    ballots alone)."""
    gh = np.concatenate([np.full(65535 // h, h) for h in range(1, 65536)])
    gw = np.concatenate([np.arange(1, 65535 // h + 1) for h in range(1, 65536)])
    want = _layout_total(gh, gw, 400) <= 227 * 1024
    got = np.array([growing.fits_shared(int(h), int(w), 400) for h, w in zip(gh, gw)])
    assert len(gh) > 700_000 and np.array_equal(got, want)
    assert int(want.sum()) == int(got.sum()) > 0
    assert 227 * 1024 - growing.compact_bytes(120, 160, 400) >= 2048
    assert 227 * 1024 - growing.compact_bytes(111, 192, 400) == 144


def test_reset_counters_zeroes_them():
    conf, frame, K = deployment("tum_default")
    cfg = Config.from_dict(conf["parameters"])
    growing.grow_rounds(compute_cells(frames.rolled_ring(frame, 1, 3, "cpu"), K, cfg), cfg)
    assert profiling.counters()["frames"] >= 1
    profiling.reset_counters()
    assert profiling.counters() == {"frames": 0, "rounds": 0, "radix_frames": 0,
                                    "multiwarp_frames": 0, "radix_passes": 0}


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
