"""deplex_tpu_torch end to end (CPU twins) vs deplex_tpu and the goldens.

TUM labels must equal the JAX package's, with 34 planes (the largest label,
the count bench.py and the reference report). On ICL (P=4) the port's cell
normals carry other float32 rounding noise than XLA's, which reorders the
growing rounds; the planes found must be the same partition, under other
label numbers. Golden F1 >= 0.95 on both frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deplex_tpu import Config as JaxConfig
from deplex_tpu import PlaneExtractor as JaxPlaneExtractor
from deplex_tpu.parallel.batch import extract_depth_batch_jit as jax_extract_depth_batch
from deplex_tpu.pipeline import extract_planes_debug as jax_extract_planes_debug
from deplex_tpu.pipeline import extract_planes_from_depth_jit as jax_extract_from_depth
from deplex_tpu_torch import Config, PlaneExtractor
from deplex_tpu_torch.parallel.batch import (BatchDepthExtractor, BatchPlaneExtractor,
                                             extract_depth_batch)
from deplex_tpu_torch.pipeline import extract_planes_debug

from .conftest import DATA, label_f1, load_golden


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def icl_image():
    from deplex_tpu.utils import DepthImage, read_intrinsics

    img = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    return img.data, read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))


def _assert_same_planes(got, ref):
    """Same partition of the pixels into planes, up to label numbering."""
    pairs = np.unique(np.stack([got, ref]), axis=1)
    assert np.unique(pairs[0]).size == pairs.shape[1] == np.unique(pairs[1]).size
    assert int(got.max()) == int(ref.max())


@pytest.fixture(scope="module")
def tum_labels(tum_image):
    depth, K = tum_image
    return PlaneExtractor(480, 640, Config(), device="cpu").process_depth(depth, K)


def test_tum_labels_equal_jax_and_34_planes(tum_image, tum_labels):
    depth, K = tum_image
    ref = np.asarray(jax_extract_from_depth(jnp.asarray(depth), jnp.asarray(K),
                                            config=JaxConfig()))
    assert tum_labels.dtype == np.int32 and tum_labels.shape == (480 * 640,)
    np.testing.assert_array_equal(tum_labels, ref)
    assert int(tum_labels.max()) == 34


def test_tum_golden_f1(tum_labels):
    f1, p, r = label_f1(tum_labels, load_golden("tum_default_labels"))
    assert f1 >= 0.95, (f1, p, r)


def test_icl_same_planes_as_jax_and_golden_f1(icl_image):
    depth, K = icl_image
    ini = str(DATA / "configs" / "ICL_living_room.ini")
    got = PlaneExtractor(480, 640, Config.from_ini(ini), device="cpu").process_depth(depth, K)
    ref = np.asarray(jax_extract_from_depth(jnp.asarray(depth), jnp.asarray(K),
                                            config=JaxConfig.from_ini(ini)))
    _assert_same_planes(got, ref)
    f1, p, r = label_f1(got, load_golden("icl_ini_labels"))
    assert f1 >= 0.95, (f1, p, r)


def test_extract_depth_batch_equals_jax(tum_image):
    depth, K = tum_image
    batch = np.stack([depth, np.roll(depth, (3, 5), (0, 1))])
    ref = np.asarray(jax_extract_depth_batch(jnp.asarray(batch), jnp.asarray(K),
                                             config=JaxConfig()))
    got = extract_depth_batch(torch.from_numpy(batch.astype(np.int32)), K, Config()).numpy()
    np.testing.assert_array_equal(got[0], ref[0])
    # The shifted frame's cell normals round differently: same planes.
    _assert_same_planes(got[1], ref[1].astype(np.int32))
    out = BatchDepthExtractor(480, 640, Config(), batch=2, device="cpu").process(batch, K)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, got)


def test_points_and_depth_entries_agree(tum_image, tum_cloud, tum_labels):
    pts, h, w = tum_cloud
    ex = PlaneExtractor(h, w, device="cpu")
    np.testing.assert_array_equal(ex.process(pts), tum_labels)


def test_batch_extractors_match_single_frames(tum_cloud):
    pts, h, w = tum_cloud
    crop = pts.reshape(h, w, 3)[:120, :160].reshape(-1, 3)
    batch = np.stack([np.roll(crop, i, axis=0) * (1.0 + 0.01 * i) for i in range(3)])
    batch = batch.astype(np.float32)
    out = BatchPlaneExtractor(120, 160, Config(), device="cpu").process(batch)
    single = PlaneExtractor(120, 160, Config(), device="cpu")
    assert out.shape == (3, 120 * 160)
    for i in range(3):
        np.testing.assert_array_equal(out[i], single.process(batch[i]))
    depth = np.ascontiguousarray(pts.reshape(h, w, 3)[:120, :160, 2]).astype(np.uint16)
    K = np.array([[520.9, 0, 80.0], [0, 521.0, 60.0], [0, 0, 1]], np.float32)
    stream = BatchDepthExtractor(120, 160, Config(), batch=2, device="cpu")
    batches = [np.stack([depth, depth]), np.stack([np.roll(depth, 4, 1)] * 2)]
    outs = list(stream.process_stream(batches, K))
    assert len(outs) == 2
    for b, o in zip(batches, outs):
        np.testing.assert_array_equal(o, stream.process(b, K))


def test_debug_intermediates_match_jax_keys(tum_cloud):
    pts, h, w = tum_cloud
    crop = np.ascontiguousarray(pts.reshape(h, w, 3)[:120, :160].reshape(-1, 3))
    got = extract_planes_debug(torch.from_numpy(crop), image_height=120, image_width=160,
                               config=Config())
    ref = jax.jit(lambda p: jax_extract_planes_debug(
        p, image_height=120, image_width=160, config=JaxConfig()))(jnp.asarray(crop))
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(ref["labels"]))
    np.testing.assert_array_equal(got["labels_map"].numpy(), np.asarray(ref["labels_map"]))
    assert got["stats"].planar.shape == ref["stats"].planar.shape


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_error_strings_match_reference(tum_cloud):
    pts, h, w = tum_cloud
    assert _message(lambda: PlaneExtractor(480, 640, Config(patch_size=0))) == \
        _message(lambda: JaxPlaneExtractor(480, 640, JaxConfig(patch_size=0)))
    for bad in (np.zeros((0, 3), np.float32), pts[: h * w // 2], np.zeros(5, np.float32)):
        assert _message(lambda: PlaneExtractor(h, w, device="cpu").process(bad)) == \
            _message(lambda: JaxPlaneExtractor(h, w).process(bad))
    small = np.zeros((10, 10), np.uint16)
    assert _message(lambda: PlaneExtractor(h, w, device="cpu").process_depth(small, np.eye(3))) \
        == _message(lambda: JaxPlaneExtractor(h, w).process_depth(small, np.eye(3)))


def test_ransac_not_ported_raises(tum_image, tum_labels):
    """A config with stage 6 (tests/test_torch_ransac.py) runs through the
    depth entry, and refinement only removes labels."""
    depth, K = tum_image
    ex = PlaneExtractor(480, 640, Config(ransac_refinement=True), device="cpu")
    labels = ex.process_depth(depth, K)
    changed = labels != tum_labels
    assert changed.any() and (labels[changed] == 0).all()


@pytest.mark.parametrize("case", ["impossible_score", "huge_patch", "zero_cloud"])
def test_edge_cases_all_zero(tum_cloud, case):
    pts, h, w = tum_cloud
    if case == "impossible_score":
        labels = PlaneExtractor(h, w, Config(min_region_planarity_score=2.0),
                                device="cpu").process(pts)
    elif case == "huge_patch":
        labels = PlaneExtractor(h, w, Config(patch_size=10**6), device="cpu").process(pts)
    else:
        labels = PlaneExtractor(h, w, device="cpu").process(np.zeros_like(pts))
    assert labels.shape == (h * w,) and (labels == 0).all()


def test_config_round_trip_through_interop():
    from deplex_tpu_torch.interop import config_from_dict

    jc = JaxConfig(patch_size=8, max_planes=32)
    assert config_from_dict(dataclasses.asdict(jc)) == Config(patch_size=8, max_planes=32)
    assert jax.devices()[0].platform == "cpu"


def _entry_point(name, device):
    """Construct an entry point of the port on `device` (None = the default)
    and run it on a small zero frame."""
    from deplex_tpu_torch import PlaneSlam

    h, w = 60, 80
    K = np.array([[60.0, 0, 40.0], [0, 60.0, 30.0], [0, 0, 1]], np.float32)
    depth = np.zeros((h, w), np.uint16)
    if name == "PlaneExtractor":
        return PlaneExtractor(h, w, Config(), device=device).process_depth(depth, K)
    if name == "BatchDepthExtractor":
        return BatchDepthExtractor(h, w, Config(), batch=1, device=device).process(
            depth[None], K)
    if name == "BatchPlaneExtractor":
        return BatchPlaneExtractor(h, w, Config(), device=device).process(
            np.zeros((1, h * w, 3), np.float32))
    slam = PlaneSlam(h, w, Config(), max_landmarks=8, device=device)
    return slam.process_frame(torch.zeros((h * w, 3)))


@pytest.mark.parametrize("name", ["PlaneExtractor", "BatchDepthExtractor",
                                  "BatchPlaneExtractor", "PlaneSlam"])
def test_entry_points_need_a_card_or_cpu(monkeypatch, name):
    """Without a card, an entry point constructed without `device` raises
    and names device="cpu"; asked for the CPU, it runs the plain twins."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_point(name, None)
    out = _entry_point(name, "cpu")
    if name != "PlaneSlam":
        assert (np.asarray(out) == 0).all()
