"""deplex_tpu_torch's precision scope: ``pipeline.full_float32`` turns TF32
off on the card only inside an entry point and gives the caller's flags back.

torch keeps the TF32 flags in two APIs, the legacy ``allow_tf32`` /
``set_float32_matmul_precision`` and the per-backend ``fp32_precision``, and
refuses to read a legacy flag that disagrees with the newer one. A caller's
state is what both APIs read (a refused read counts as a value), and it must
come back exactly. The reference asks for full precision per operation
(``precision=HIGHEST``) and leaves global state alone; so must the port.
On the CPU the scope changes nothing, so the entry-point cases also record
which function entered the scope, and on which device: each entry point
must enter it itself or through the function named in ``SCOPED_BY``. On
the card ``chip_smoke.py`` [tf32] checks the same entry points under a
caller's TF32.
"""

import dataclasses
import sys

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.distributed as dist

from deplex_tpu_torch import Config, PlaneExtractor, PlaneSlam
from deplex_tpu_torch.interop import ba_problem_from_numpy
from deplex_tpu_torch.parallel.batch import (BatchDepthExtractor, BatchPlaneExtractor,
                                             ShardedPlaneExtractor, extract_depth_batch,
                                             extract_depth_batch_jit, extract_planes_batch,
                                             extract_planes_batch_jit)
from deplex_tpu_torch.parallel.distributed import make_mesh
from deplex_tpu_torch.parallel.spatial import extract_planes_spatial
from deplex_tpu_torch.parallel.verify import (synth_ba_problem, synth_depth, synth_intrinsics,
                                              verify_config)
from deplex_tpu_torch.pipeline import (backproject_device, extract_planes, extract_planes_debug,
                                       extract_planes_from_depth_jit, extract_planes_jit,
                                       extract_primitives, extract_primitives_jit, full_float32)
from deplex_tpu_torch.profiling import stage_timings
from deplex_tpu_torch.slam.ba import run_ba, run_ba_sharded
from deplex_tpu_torch.slam.pose_graph import optimize_pose_graph
from deplex_tpu_torch.utils.depth_image import backproject

B = torch.backends
SETTINGS = {"generic": B, "cuda_all": B.cudnn, "cuda_matmul": B.cuda.matmul,
            "cudnn_conv": B.cudnn.conv, "cudnn_rnn": B.cudnn.rnn, "mkldnn_all": B.mkldnn,
            "mkldnn_matmul": B.mkldnn.matmul, "mkldnn_conv": B.mkldnn.conv,
            "mkldnn_rnn": B.mkldnn.rnn}


def _read(getter):
    try:
        return getter()
    except RuntimeError:
        return "refused"


def flags() -> dict:
    """Everything both APIs read."""
    out = {name: s.fp32_precision for name, s in SETTINGS.items()}
    out["float32_matmul_precision"] = _read(torch.get_float32_matmul_precision)
    out["matmul_allow_tf32"] = _read(lambda: B.cuda.matmul.allow_tf32)
    out["cudnn_allow_tf32"] = _read(lambda: B.cudnn.allow_tf32)
    return out


# What callers set, through either API or both (later settings win).
CALLERS = {
    "default": [],
    "allow_tf32": [("legacy_matmul", True), ("legacy_cudnn", True)],
    "allow_tf32_off": [("legacy_matmul", False), ("legacy_cudnn", False)],
    "fp32_precision": [("cuda_matmul", "tf32"), ("cudnn_conv", "tf32")],
    "fp32_precision_ieee": [("cuda_matmul", "ieee"), ("cudnn_conv", "ieee")],
    "matmul_precision_high": [("float32_matmul_precision", "high")],
    "generic_tf32": [("generic", "tf32")],
    "legacy_then_new": [("legacy_matmul", True), ("cuda_matmul", "ieee")],
    "new_then_legacy": [("cuda_matmul", "tf32"), ("legacy_cudnn", False)],
}


def set_caller(name: str) -> None:
    for what, value in CALLERS[name]:
        if what == "legacy_matmul":
            B.cuda.matmul.allow_tf32 = value
        elif what == "legacy_cudnn":
            B.cudnn.allow_tf32 = value
        elif what == "float32_matmul_precision":
            torch.set_float32_matmul_precision(value)
        else:
            SETTINGS[what].fp32_precision = value


_DEFAULT = {name: s.fp32_precision for name, s in SETTINGS.items()}


@pytest.fixture(autouse=True)
def _process_defaults():
    """Each test starts from, and leaves, this process's default flags."""
    before = flags()
    yield
    torch.set_float32_matmul_precision("highest")
    B.cudnn.allow_tf32 = True
    for name, s in SETTINGS.items():
        s.fp32_precision = _DEFAULT[name]
    assert flags() == before


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_scope_restores_both_apis(caller):
    set_caller(caller)
    before = flags()
    with full_float32(torch.device("cuda")):
        inside = flags()
    assert flags() == before
    # Inside: no TF32 in either API, and cuBLAS and cuDNN read a consistent
    # state (a refused read would raise in a card's matrix product).
    assert inside["matmul_allow_tf32"] is False and inside["cudnn_allow_tf32"] is False
    assert inside["cuda_matmul"] == inside["cudnn_conv"] == inside["cudnn_rnn"] == "ieee"


@pytest.mark.parametrize("caller", ["allow_tf32", "fp32_precision"])
def test_scope_restores_on_exception(caller):
    set_caller(caller)
    before = flags()
    with pytest.raises(KeyError):
        with full_float32("cuda"):
            assert flags()["matmul_allow_tf32"] is False
            raise KeyError("inside")
    assert flags() == before


def test_nested_scopes_and_cpu_scope_change_nothing_outside():
    set_caller("allow_tf32")
    before = flags()
    with full_float32("cpu"):
        assert flags() == before
    with full_float32("cuda"):
        inside = flags()
        with full_float32("cuda"):
            assert flags() == inside
        assert flags() == inside
    assert flags() == before


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


H, W = 48, 64


def _slam(frames: int = 3) -> PlaneSlam:
    cfg = Config(**dataclasses.asdict(verify_config()))
    slam = PlaneSlam(H, W, cfg, max_landmarks=8, device="cpu")
    K = torch.from_numpy(synth_intrinsics())
    for d in synth_depth(frames):
        slam.process_frame(backproject_device(torch.from_numpy(d.astype(np.float32)), K))
    return slam


def _entry_points():
    """name -> a call of that entry point on the CPU at a small size."""
    cfg = Config(**dataclasses.asdict(verify_config()))
    K = synth_intrinsics()
    depth = synth_depth(2)
    pts = np.stack([backproject(d, K) for d in depth])
    pts_t = torch.from_numpy(pts)
    kw = dict(image_height=H, image_width=W, config=cfg)
    prob = ba_problem_from_numpy(synth_ba_problem(4)._asdict())

    def slam_then(method):
        def run():
            slam = _slam()
            getattr(slam, method)(**({"min_shared": 1} if method == "optimize_trajectory"
                                     else {"iterations": 2}))
        return run

    def pose_graph():
        slam = _slam()
        optimize_pose_graph(slam.build_pose_graph(min_shared=1), iterations=2)

    return {
        "extract_planes": lambda: extract_planes(pts_t[0], **kw),
        "extract_planes_debug": lambda: extract_planes_debug(pts_t[0], **kw),
        "extract_primitives": lambda: extract_primitives(
            pts_t[0], **{**kw, "config": cfg.replace(cylinder_extraction=True)}),
        "extract_depth_batch": lambda: extract_depth_batch(torch.from_numpy(
            depth.view(np.int16)).view(torch.uint16), K, cfg),
        "extract_planes_batch": lambda: extract_planes_batch(pts_t, **kw),
        "extract_planes_jit": lambda: extract_planes_jit(pts_t[0], **kw),
        "extract_planes_from_depth_jit": lambda: extract_planes_from_depth_jit(torch.from_numpy(
            depth[0].view(np.int16)).view(torch.uint16), K, config=cfg),
        "extract_primitives_jit": lambda: extract_primitives_jit(
            pts_t[0], **{**kw, "config": cfg.replace(cylinder_extraction=True)}),
        "extract_depth_batch_jit": lambda: extract_depth_batch_jit(torch.from_numpy(
            depth.view(np.int16)).view(torch.uint16), K, config=cfg),
        "extract_planes_batch_jit": lambda: extract_planes_batch_jit(pts_t, **kw),
        "PlaneExtractor.process": lambda: PlaneExtractor(H, W, cfg, device="cpu").process(
            pts[0]),
        "PlaneExtractor.process_depth": lambda: PlaneExtractor(
            H, W, cfg, device="cpu").process_depth(depth[0], K),
        "PlaneExtractor.process_primitives": lambda: PlaneExtractor(
            H, W, cfg, device="cpu").process_primitives(pts[0]),
        "BatchDepthExtractor.process": lambda: BatchDepthExtractor(
            H, W, cfg, batch=2, device="cpu").process(depth, K),
        "BatchPlaneExtractor.process": lambda: BatchPlaneExtractor(
            H, W, cfg, device="cpu").process(pts),
        "ShardedPlaneExtractor.process": lambda: ShardedPlaneExtractor(
            H, W, cfg, device="cpu").process(pts),
        "PlaneSlam.process_frame": _slam,
        "PlaneSlam.refine": slam_then("refine"),
        "PlaneSlam.optimize_trajectory": slam_then("optimize_trajectory"),
        "run_ba": lambda: run_ba(prob, iterations=2),
        "run_ba_sharded": lambda: run_ba_sharded(prob, iterations=2),
        "optimize_pose_graph": pose_graph,
        "extract_planes_spatial": lambda: extract_planes_spatial(
            pts_t[0], **kw, mesh=make_mesh("space"), device="cpu"),
        "stage_timings": lambda: stage_timings(pts[0], H, W, cfg, repeats=1, device="cpu"),
    }


NEEDS_A_GROUP = {"ShardedPlaneExtractor.process", "run_ba_sharded", "extract_planes_spatial"}

# The function (its __qualname__) that opens the scope for each entry point:
# the entry point itself, or the function it hands its tensors to.
SCOPED_BY = {
    "extract_planes_jit": "compiled_planes",
    "extract_planes_from_depth_jit": "compiled_planes",
    "extract_depth_batch_jit": "compiled_planes",
    "extract_planes_batch_jit": "compiled_planes",
    "PlaneExtractor.process": "compiled_planes",
    "PlaneExtractor.process_depth": "compiled_planes",
    "PlaneExtractor.process_primitives": "extract_primitives_jit",
    "BatchDepthExtractor.process": "compiled_planes",
    "BatchPlaneExtractor.process": "compiled_planes",
    "ShardedPlaneExtractor.process": "compiled_planes",
}


@pytest.fixture
def scopes(monkeypatch):
    """Every module's ``full_float32`` replaced by a recorder of (the
    __qualname__ of the function that entered it, the device type)."""
    real = full_float32
    entered = []

    def recorder(device):
        entered.append((sys._getframe(1).f_code.co_qualname, torch.device(device).type))
        return real(device)

    for name, module in list(sys.modules.items()):
        if name.startswith("deplex_tpu_torch") and getattr(module, "full_float32", None) is real:
            monkeypatch.setattr(module, "full_float32", recorder)
    return entered


@pytest.mark.parametrize("caller", ["allow_tf32", "fp32_precision"])
@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_points_leave_the_callers_flags(entry, caller, request, scopes):
    if entry in NEEDS_A_GROUP:
        request.getfixturevalue("world_of_one")
    set_caller(caller)
    before = flags()
    _entry_points()[entry]()
    assert flags() == before
    if caller == "allow_tf32":
        assert B.cuda.matmul.allow_tf32 is True and B.cudnn.allow_tf32 is True
    else:
        assert B.cuda.matmul.fp32_precision == "tf32" and B.cudnn.conv.fp32_precision == "tf32"
    # The entry point ran inside the scope, opened on its inputs' device.
    assert (SCOPED_BY.get(entry, entry), "cpu") in scopes, scopes
    assert {device for _, device in scopes} == {"cpu"}
