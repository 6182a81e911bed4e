"""Stage 1 of deplex_tpu_torch (the CPU twin of the cell-moments kernel) vs
deplex_tpu: the XLA path compute_cell_stats(backproject_device(...)) and the
Pallas kernel cell_moments_pallas(..., interpret=True).

Discrete outputs (valid counts, discontinuity counts, planar mask) must be
equal. Floats: coord_sum rtol 1e-5 / atol 1e-2; scatter within
1e-4 * trace + 1e-2 (tests/test_pallas_cellstats.py); tol rtol 1e-4. The
sums are taken in another order than XLA's segment matmuls, so normals of
eigengap-degenerate cells may move; as in test_pallas_cellstats.py, those
must stay a vanishing fraction of the planar cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from deplex_tpu import Config as JaxConfig
from deplex_tpu.ops.cellstats import compute_cell_stats as jax_compute_cell_stats
from deplex_tpu.ops.cellstats import moments_band_plan
from deplex_tpu.ops.pallas_cellstats import cell_moments_pallas
from deplex_tpu.pipeline import backproject_device as jax_backproject
from deplex_tpu.utils import DepthImage as JaxDepthImage
from deplex_tpu_torch import Config
from deplex_tpu_torch.ops.cellstats import cell_moments_reference, moments_band_plan_exists
from deplex_tpu_torch.pipeline import compute_cell_stats

from .conftest import DATA


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def icl_image():
    from deplex_tpu.utils import read_intrinsics

    img = JaxDepthImage(str(DATA / "icl_nuim" / "0.png"))
    return img.data, read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))


def _jax_stats(depth, K, patch):
    H, W = depth.shape
    cfg = JaxConfig(patch_size=patch)
    fn = jax.jit(lambda d, k: jax_compute_cell_stats(jax_backproject(d, k), H, W, cfg))
    return fn(jnp.asarray(depth), jnp.asarray(K, jnp.float32))


def _ours(depth, K, patch):
    return compute_cell_stats(torch.from_numpy(depth.astype(np.int32))[None],
                              torch.as_tensor(K, dtype=torch.float32), Config(patch_size=patch))


def _assert_scatter_close(got, ref):
    tr = np.trace(ref, axis1=-2, axis2=-1)
    err = np.abs(got - ref)
    assert (err <= 1e-4 * tr[..., None, None] + 1e-2).all(), float(err.max())


def _assert_stats_match(got, ref):
    planar = np.asarray(ref.planar)
    np.testing.assert_array_equal(got.planar[0].numpy(), planar)
    np.testing.assert_allclose(got.coord_sum[0].numpy(), np.asarray(ref.coord_sum),
                               rtol=1e-5, atol=1e-2)
    _assert_scatter_close(got.scatter[0].numpy(), np.asarray(ref.scatter))
    np.testing.assert_allclose(got.tol[0].numpy(), np.asarray(ref.tol), rtol=1e-4)
    np.testing.assert_allclose(got.mean[0].numpy(), np.asarray(ref.mean), rtol=1e-5, atol=1e-4)
    assert float(got.nr_pts) == float(ref.nr_pts)
    if planar.any():
        # Measured on TUM, ICL and the P=7 crop: median 2e-7, 99th
        # percentile 2e-4, under 0.5% of planar cells past 1e-3. (MSE and d
        # of noise-floor cells are lambda_min rounding noise; not compared.)
        ndiff = np.abs(got.normal[0].numpy() - np.asarray(ref.normal)).max(-1)[planar]
        assert float((ndiff > 1e-3).mean()) < 0.01
        assert float(np.median(ndiff)) < 1e-5
        assert float(np.quantile(ndiff, 0.99)) < 1e-3


def test_tum_p10_matches_xla(tum_image):
    depth, K = tum_image
    _assert_stats_match(_ours(depth, K, 10), _jax_stats(depth, K, 10))


def test_icl_p4_matches_xla(icl_image):
    depth, K = icl_image
    _assert_stats_match(_ours(depth, K, 4), _jax_stats(depth, K, 4))


@pytest.mark.parametrize("frame,patch", [("tum", 10), ("icl", 4)])
def test_moments_match_pallas_interpret(tum_image, icl_image, frame, patch):
    depth, K = tum_image if frame == "tum" else icl_image
    ref = cell_moments_pallas(jnp.asarray(depth)[None], jnp.asarray(K, jnp.float32),
                              JaxConfig(patch_size=patch), interpret=True)
    got = cell_moments_reference(torch.from_numpy(depth.astype(np.int32))[None],
                                 torch.as_tensor(K), Config(patch_size=patch))
    for f in ("nr_valid", "disc_h", "disc_v"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.coord_sum.numpy(), np.asarray(ref.coord_sum),
                               rtol=1e-5, atol=1e-2)
    _assert_scatter_close(got.scatter.numpy(), np.asarray(ref.scatter))
    np.testing.assert_allclose(got.diam.numpy(), np.asarray(ref.diam), rtol=1e-5, atol=1e-3)


def test_odd_patch_walk_wraps(tum_image):
    """P=7 on a 231x315 crop: the mid-row walk wraps into the next row."""
    depth, K = tum_image
    crop = np.ascontiguousarray(depth[:231, :315])
    assert moments_band_plan(33, 7, 315) is not None
    _assert_stats_match(_ours(crop, K, 7), _jax_stats(crop, K, 7))


def test_grid_without_band_plan():
    """P=40 on an 80x1040 frame has no band plan in the reference, which then
    takes the plainly centered moments; so must the port."""
    H, W, P = 80, 1040, 40
    assert moments_band_plan(H // P, P, W) is None
    assert not moments_band_plan_exists(H // P, P, W)
    rng = np.random.default_rng(11)
    z = rng.uniform(500, 3000, size=(H, W)).astype(np.uint16)
    z[:, :400] = 1200
    z[:40, 600:] = (1500 + np.arange(440) * 2)[None, :].astype(np.uint16)
    K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]], np.float32)
    _assert_stats_match(_ours(z, K, P), _jax_stats(z, K, P))


def test_band_plan_existence_matches_reference():
    for P in (1, 2, 3, 4, 7, 10, 16, 40):
        for gh in (1, 3, 8, 10, 33, 48, 90, 120):
            for Wc in (40, 128, 640, 1040, 1280, 4096):
                assert moments_band_plan_exists(gh, P, Wc) == \
                    (moments_band_plan(gh, P, Wc) is not None), (P, gh, Wc)


def test_depth_and_points_entries_agree(tum_image):
    """The depth entry back-projects exactly as the points entry reads."""
    from deplex_tpu_torch.pipeline import backproject_device

    depth, K = tum_image
    d = torch.from_numpy(np.ascontiguousarray(depth[:120, :160]).view(np.int16)).view(torch.uint16)
    Kt = torch.as_tensor(K)
    pts = backproject_device(d, Kt).reshape(1, 120, 160, 3)
    a = cell_moments_reference(d[None], Kt, Config())
    b = cell_moments_reference(pts, None, Config())
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_batch_frames_independent(tum_image):
    depth, K = tum_image
    crop = depth[:240, :320].astype(np.int32)
    batch = torch.from_numpy(np.stack([crop, np.roll(crop, 5, axis=1)]))
    Kt = torch.as_tensor(K)
    both = compute_cell_stats(batch, Kt, Config())
    for i in range(2):
        one = compute_cell_stats(batch[i:i + 1], Kt, Config())
        for f in ("planar", "coord_sum", "scatter", "mse"):
            assert torch.equal(getattr(both, f)[i], getattr(one, f)[0]), f


def test_k1_wrapper_takes_the_intrinsics_from_the_depths_device():
    """K1 reads fx, fy, cx and cy from device memory: for a source off the
    CPU (the meta device stands in for the card) a host or numpy K is
    refused, a K on the source's device is taken."""
    from deplex_tpu_torch.kernels.cellstats import check_intrinsics

    src = torch.empty((1, 20, 20), dtype=torch.uint16, device="meta")
    for K in (torch.eye(3), np.eye(3, dtype=np.float32)):
        with pytest.raises(ValueError, match="depth's device"):
            check_intrinsics(src, K)
    check_intrinsics(src, torch.eye(3, device="meta"))
    check_intrinsics(torch.empty((1, 20, 20), dtype=torch.uint16), torch.eye(3))
