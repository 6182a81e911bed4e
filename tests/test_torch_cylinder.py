"""deplex_tpu_torch's cylinders vs deplex_tpu's, on the CPU.

``ops.cylinder.extract_cylinders`` is fed the reference's own stage state
(CellStats, RoundData, through ``interop``) and must give its labels and
counts exactly and its cylinder parameters to float32 tolerances: the port
solves the Kasa 3x3 system by Cramer's rule where the reference calls an LU
solve, and sums cells in another order. ``pipeline.extract_primitives`` end
to end must give the reference's plane and cylinder labels, on the 240x320
cylinder scene of tests/test_cylinder.py, on the TUM frame and at 720p (the
scene of tests/test_stress.py).
"""

import functools
import pathlib

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu import Config as JaxConfig
from deplex_tpu import PlaneExtractor as JaxPlaneExtractor
from deplex_tpu.ops.cellstats import compute_cell_stats as jax_cell_stats
from deplex_tpu.ops.cylinder import extract_cylinders as jax_extract_cylinders
from deplex_tpu.ops.growing import grow_rounds as jax_grow_rounds
from deplex_tpu.pipeline import extract_primitives_jit
from deplex_tpu_torch import Config, PlaneExtractor
from deplex_tpu_torch.interop import (cell_stats_from_numpy, cylinder_segments_from_numpy,
                                      fields_of, round_data_from_numpy)
from deplex_tpu_torch.ops.cylinder import (CylinderSegments, extract_cylinders,
                                           solve3_symmetric)
from deplex_tpu_torch.pipeline import extract_primitives
from deplex_tpu_torch.utils import DepthImage, read_intrinsics
from deplex_tpu_torch.utils.scenes import cylinder_scene, hires_scene

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"

# tests/test_cylinder.py's config, and tests/test_stress.py's at 720p.
CYL = dict(patch_size=8, cylinder_extraction=True, max_planes=16,
           min_region_growing_cells_activated=3, min_region_growing_candidate_size=3,
           max_region_growing_rounds=64, depth_discontinuity_threshold=600.0)
HIRES = dict(patch_size=8, max_planes=32, cylinder_extraction=True,
             min_region_growing_cells_activated=3, min_region_growing_candidate_size=3,
             max_region_growing_rounds=64)

# Cylinder parameters of the port against the reference's: axis entries (up
# to sign), center in mm (the scenes sit 2000-4000 mm away), radius and rmse
# relative.
AXIS_TOL, CENTER_TOL_MM, RADIUS_RTOL, RMSE_RTOL, RMSE_ATOL = 1e-4, 0.5, 1e-4, 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tum_scene():
    img = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    return img.transform_to_pcd(K), img.height, img.width


SCENES = {"cylinder240": (cylinder_scene, CYL), "tum": (tum_scene, dict(cylinder_extraction=True))}


@functools.lru_cache(maxsize=None)
def scene(name):
    make, cfg = SCENES[name]
    pts, H, W = make()
    return pts, H, W, Config(**cfg), JaxConfig(**cfg)


@functools.lru_cache(maxsize=None)
def jax_stage_state(name):
    """The reference's CellStats, RoundData and cylinders on a scene."""
    pts, H, W, _, jcfg = scene(name)
    stats = jax.jit(lambda p: jax_cell_stats(p, H, W, jcfg))(pts)
    rounds = jax.jit(lambda s: jax_grow_rounds(s, jcfg))(stats)
    cyl_map, cyl = jax.jit(lambda s, r: jax_extract_cylinders(s, r, jcfg))(stats, rounds)
    return fields_of(stats), fields_of(rounds), np.asarray(cyl_map), fields_of(cyl)


def assert_cylinders_close(got, ref, n):
    """Slots [0, n) of two unbatched CylinderSegments (numpy fields)."""
    for i in range(n):
        sign = np.sign(np.dot(got.axis[i], ref["axis"][i]))
        np.testing.assert_allclose(sign * got.axis[i], ref["axis"][i], rtol=0, atol=AXIS_TOL)
    np.testing.assert_allclose(got.center[:n], ref["center"][:n], rtol=0, atol=CENTER_TOL_MM)
    np.testing.assert_allclose(got.radius[:n], ref["radius"][:n], rtol=RADIUS_RTOL, atol=0)
    np.testing.assert_allclose(got.rmse[:n], ref["rmse"][:n], rtol=RMSE_RTOL, atol=RMSE_ATOL)
    np.testing.assert_array_equal(got.size, ref["size"])
    for f in ("axis", "center", "radius", "rmse"):
        assert not np.asarray(getattr(got, f))[n:].any(), f"{f}: unfilled slots not zero"


@pytest.mark.parametrize("name", list(SCENES))
def test_extract_cylinders_matches_jax_fed_its_state(name):
    stats_np, rounds_np, ref_map, ref = jax_stage_state(name)
    _, _, _, cfg, _ = scene(name)
    stats = cell_stats_from_numpy(stats_np, add_batch_axis=True)
    rounds = round_data_from_numpy(rounds_np, add_batch_axis=True)
    cyl_map, cyl = extract_cylinders(stats, rounds, cfg)
    assert cyl_map.dtype == torch.int32 and cyl.nr_cylinders.dtype == torch.int32
    np.testing.assert_array_equal(cyl_map[0].numpy(), ref_map)
    n = int(cyl.nr_cylinders[0])
    assert n == int(ref["nr_cylinders"])
    assert_cylinders_close(CylinderSegments(*(f[0].numpy() for f in cyl)), ref, n)
    if name == "cylinder240":
        assert n >= 1
    else:
        assert n <= 3


@pytest.mark.parametrize("name", list(SCENES))
def test_extract_primitives_matches_jax(name):
    pts, H, W, cfg, jcfg = scene(name)
    got = extract_primitives(torch.from_numpy(pts), image_height=H, image_width=W, config=cfg)
    ref = extract_primitives_jit(pts, image_height=H, image_width=W, config=jcfg)
    for key in ("plane_labels", "cylinder_labels"):
        assert got[key].shape == (H * W,) and got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    n = int(got["cylinders"].nr_cylinders)
    assert n == int(ref["cylinders"].nr_cylinders)
    assert_cylinders_close(type(got["cylinders"])(*(f.numpy() for f in got["cylinders"])),
                           fields_of(ref["cylinders"]), n)
    plane = got["plane_labels"].numpy()
    assert plane.max() >= 1
    assert not ((plane > 0) & (got["cylinder_labels"].numpy() > 0)).any()


def test_process_primitives_on_the_cylinder_scene():
    """tests/test_cylinder.py's bounds through the entry point, with the
    cylinder switch off in the config: process_primitives forces it on."""
    pts, H, W, _, _ = scene("cylinder240")
    cfg = Config(**{**CYL, "cylinder_extraction": False})
    out = PlaneExtractor(H, W, cfg, device="cpu").process_primitives(pts)
    assert isinstance(out["plane_labels"], np.ndarray)
    assert out["cylinder_labels"].shape == (H * W,) and out["cylinder_labels"].dtype == np.int32
    cyl = out["cylinders"]
    assert isinstance(cyl, CylinderSegments) and cyl.radius.shape == (cfg.max_cylinders,)
    n = int(cyl.nr_cylinders)
    assert n >= 1
    i = int(np.argmax(cyl.size[:n]))
    assert abs(float(cyl.radius[i]) - 400.0) / 400.0 < 0.08
    assert abs(cyl.axis[i][0]) > 0.98
    assert out["plane_labels"].max() >= 1
    assert (out["cylinder_labels"] > 0).sum() > 500
    ref = JaxPlaneExtractor(H, W, JaxConfig(**{**CYL, "cylinder_extraction": False}))
    np.testing.assert_array_equal(out["cylinder_labels"],
                                  ref.process_primitives(pts)["cylinder_labels"])


@pytest.mark.parametrize("bad", [np.zeros((10, 3)), np.zeros(24 * 32 * 3), np.zeros((24 * 32, 2))],
                         ids=["rows", "flat", "columns"])
def test_process_primitives_shape_errors_match_jax(bad):
    with pytest.raises(ValueError) as ours:
        PlaneExtractor(24, 32, Config(patch_size=8), device="cpu").process_primitives(bad)
    with pytest.raises(ValueError) as ref:
        JaxPlaneExtractor(24, 32, JaxConfig(patch_size=8)).process_primitives(bad)
    assert str(ours.value) == str(ref.value)
    assert "doesn't match image shape" in str(ours.value)


def test_720p_primitives_match_jax():
    """BASELINE.json config 4: 1280x720, P=8, cylinders on. The port's
    labels equal the reference's, and tests/test_stress.py's bounds hold."""
    pts, H, W = hires_scene()
    got = extract_primitives(torch.from_numpy(pts), image_height=H, image_width=W,
                             config=Config(**HIRES))
    ref = extract_primitives_jit(pts, image_height=H, image_width=W, config=JaxConfig(**HIRES))
    for key in ("plane_labels", "cylinder_labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    cyl = type(got["cylinders"])(*(f.numpy() for f in got["cylinders"]))
    n = int(cyl.nr_cylinders)
    assert n >= 1 and n == int(ref["cylinders"].nr_cylinders)
    assert_cylinders_close(cyl, fields_of(ref["cylinders"]), n)
    i = int(np.argmax(cyl.size[:n]))
    assert abs(float(cyl.radius[i]) - 400.0) / 400.0 < 0.1
    assert (got["cylinder_labels"].numpy() > 0).sum() > 2000
    plane = got["plane_labels"].numpy()
    assert np.unique(plane[plane > 0]).size >= 2 and (plane > 0).mean() > 0.35


def test_cylinder_segments_from_numpy():
    _, _, _, ref = jax_stage_state("cylinder240")
    seg = cylinder_segments_from_numpy(ref, add_batch_axis=True)
    assert seg.nr_cylinders.dtype == torch.int32 and seg.nr_cylinders.shape == (1,)
    assert seg.axis.shape == (1, 16, 3) and seg.axis.dtype == torch.float32
    for f in CylinderSegments._fields:
        np.testing.assert_array_equal(getattr(seg, f)[0].numpy(), ref[f])


def test_scenes_are_the_reference_tests_scenes():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_cylinder_test", pathlib.Path(__file__).parent / "test_cylinder.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    np.testing.assert_array_equal(cylinder_scene()[0], module.cylinder_scene()[0])
    pts, H, W = hires_scene()
    assert pts.shape == (H * W, 3) and (H, W) == (720, 1280) and np.isfinite(pts).all()


def test_solve3_symmetric_matches_numpy():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 3, 3))
    A = (X @ X.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    rhs = rng.normal(size=(64, 3)).astype(np.float32)
    t = torch.from_numpy
    x = solve3_symmetric(t(A[:, 0, 0]), t(A[:, 0, 1]), t(A[:, 0, 2]), t(A[:, 1, 1]),
                         t(A[:, 1, 2]), t(A[:, 2, 2]), t(rhs[:, 0]), t(rhs[:, 1]), t(rhs[:, 2]))
    ref = np.linalg.solve(A.astype(np.float64), rhs.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(torch.stack(x, -1).numpy(), ref, rtol=1e-3, atol=1e-3)
    x0, _, _ = solve3_symmetric(*(torch.zeros(1),) * 6, *(torch.zeros(1),) * 3)
    assert not torch.isfinite(x0).any()
