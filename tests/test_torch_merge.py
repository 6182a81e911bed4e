"""Stage 4-5 of deplex_tpu_torch (the CPU twin of the merge kernel) vs
deplex_tpu's plane_adjacency + merge_planes_from_adjacency, fed the
reference's own labels_map and PlaneSegments.

Discrete outputs must be equal: adjacency, merge_labels, merged cell labels
and pixel labels. Merged stats: n, mean and d to rtol 1e-4, normals to 1e-4
absolute, scatters to 1e-4 of their trace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deplex_tpu import Config as JaxConfig
from deplex_tpu.ops.cellstats import compute_cell_stats as jax_compute_cell_stats
from deplex_tpu.ops.growing import grow_planes as jax_grow_planes
from deplex_tpu.ops.merge import apply_label_lut as jax_apply_label_lut
from deplex_tpu.ops.merge import merge_planes as jax_merge_planes
from deplex_tpu.ops.merge import plane_adjacency as jax_plane_adjacency
from deplex_tpu.ops.merge import rasterize_labels as jax_rasterize
from deplex_tpu.pipeline import backproject_device as jax_backproject
from deplex_tpu_torch import interop
from deplex_tpu_torch.ops import merge

from .conftest import DATA


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _staircases():
    """Random box scenes: many touching coplanar segments to merge."""
    rng = np.random.default_rng(7)
    h, w = 120, 160
    frames = []
    for _ in range(4):
        z = np.full((h, w), 4000.0, np.float32)
        for _ in range(6):
            r0, c0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
            z[r0:r0 + 40, c0:c0 + 40] = rng.uniform(2000, 6000)
        frames.append(z)
    K = jnp.asarray([[200.0, 0, w / 2], [0, 200.0, h / 2], [0, 0, 1]], jnp.float32)
    pts = jax.vmap(lambda d: jax_backproject(d, K))(jnp.asarray(np.stack(frames)))
    return np.asarray(pts), h, w, JaxConfig(patch_size=10)


def _case(name, tum_cloud, icl_cloud):
    if name == "tum":
        pts, h, w = tum_cloud
        return pts[None], h, w, JaxConfig()
    if name == "icl":
        pts, h, w = icl_cloud
        return pts[None], h, w, JaxConfig.from_ini(str(DATA / "configs" / "ICL_living_room.ini"))
    if name == "empty":
        return np.zeros((1, 480 * 640, 3), np.float32), 480, 640, JaxConfig()
    return _staircases()


@pytest.mark.parametrize("name", ["tum", "icl", "staircases", "empty"])
def test_merge_matches_jax(tum_cloud, icl_cloud, name):
    pts, H, W, jcfg = _case(name, tum_cloud, icl_cloud)
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    P = min(cfg.patch_size, H, W)

    @jax.jit
    def run(p):
        stats = jax.vmap(lambda q: jax_compute_cell_stats(q, H, W, jcfg))(p)
        lm, seg = jax.vmap(lambda s: jax_grow_planes(s, jcfg))(stats)
        assoc = jax.vmap(lambda x: jax_plane_adjacency(x, jcfg.max_planes))(lm)
        ml, merged = jax.vmap(lambda x, s: jax_merge_planes(x, s, jcfg))(lm, seg)
        cell = jax.vmap(jax_apply_label_lut)(lm, ml)
        labels = jax.vmap(lambda x, m: jax_rasterize(x, m, H, W, P))(lm, ml)
        return lm, seg, assoc, ml, merged, cell, labels

    lm_j, seg_j, assoc_j, ml_j, merged_j, cell_j, labels_j = run(jnp.asarray(pts))
    lm = torch.from_numpy(np.array(lm_j))
    seg = interop.plane_segments_from_numpy(interop.fields_of(seg_j))

    assoc = merge.plane_adjacency(lm, cfg.max_planes)
    np.testing.assert_array_equal(assoc.numpy(), np.asarray(assoc_j))
    ml, merged = merge.merge_planes_from_adjacency(assoc, seg, cfg)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ml_j))
    np.testing.assert_allclose(merged.n.numpy(), np.asarray(merged_j.n), rtol=1e-4)
    np.testing.assert_allclose(merged.normal.numpy(), np.asarray(merged_j.normal), atol=1e-4)
    np.testing.assert_allclose(merged.mean.numpy(), np.asarray(merged_j.mean),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(merged.d.numpy(), np.asarray(merged_j.d), rtol=1e-4, atol=1e-3)
    tr = np.trace(np.asarray(merged_j.scatter), axis1=-2, axis2=-1)
    assert (np.abs(merged.scatter.numpy() - np.asarray(merged_j.scatter))
            <= 1e-4 * np.abs(tr)[..., None, None] + 1e-2).all()

    np.testing.assert_array_equal(merge.apply_label_lut(lm, ml).numpy(), np.asarray(cell_j))
    labels = merge.rasterize_labels(lm, ml, H, W, P)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_j))
    if name == "tum":   # the frame's 34 segments merge into 32 planes
        assert int((ml != torch.arange(cfg.max_planes)).sum()) == 2
    if name == "empty":
        np.testing.assert_array_equal(ml.numpy(), np.arange(cfg.max_planes)[None])


def test_adjacency_stencil_skips_last_row_and_column():
    lm = torch.zeros((1, 4, 4), dtype=torch.int32)
    lm[0, 3, :] = 2          # last row only touches plane 1 across rows
    lm[0, :3, :] = 1
    lm[0, 0, 3] = 3          # last column: its right/down pairs are never read
    lm[0, 1, 3] = 4
    A = merge.plane_adjacency(lm, 8)[0]
    ref = np.asarray(jax_plane_adjacency(jnp.asarray(lm[0].numpy()), 8))
    np.testing.assert_array_equal(A.numpy(), ref)
    assert bool(A[0, 1]) and bool(A[1, 0])


def test_rasterize_remainder_pixels_zero():
    lm = torch.tensor([[[1, 2], [0, 1]]], dtype=torch.int32)
    ml = torch.arange(4, dtype=torch.int32)[None]
    got = merge.rasterize_labels(lm, ml, 7, 9, 3)
    ref = np.asarray(jax_rasterize(jnp.asarray(lm[0].numpy()), jnp.arange(4, dtype=jnp.int32),
                                   7, 9, 3))
    np.testing.assert_array_equal(got[0].numpy(), ref)
