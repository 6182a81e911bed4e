"""Stage 4-5 of deplex_tpu_torch (the CPU twin of the merge kernel) vs
deplex_tpu's plane_adjacency + merge_planes_from_adjacency and its vmapped
merge_planes, fed the reference's own labels_map and PlaneSegments or the
seeded stage-4 cases of tools/kernel_bench.random_merge_case; the twin vs
the TPU merge kernel itself in interpret mode; the kernel wrapper on CPU
tensors.

Discrete outputs must be equal: adjacency, merge_labels, merged cell labels
and pixel labels. Merged stats: n, mean and d to rtol 1e-4, normals to 1e-4
absolute, scatters to 1e-4 of their trace. Against the TPU kernel, normals
to 1e-4 absolute too: its polynomial atan2 is within 2.8e-7 of a real one
(deplex_tpu/ops/pallas_merge.py).
"""

import dataclasses
import zlib

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
from deplex_tpu.ops.pallas_merge import merge_planes_pallas_batched
from deplex_tpu.pipeline import backproject_device as jax_backproject
from deplex_tpu_torch import Config, interop
from deplex_tpu_torch import kernels
from deplex_tpu_torch.ops import merge
from deplex_tpu_torch.tools.kernel_bench import (MERGE_KINDS, merge_case_tensors,
                                                 random_merge_case)

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


_JAX_RUNS = {}


def _jax_run(name, tum_cloud, icl_cloud):
    """The JAX package's stages 1-5 on a named case, once per case:
    (H, W, P, port config, JAX config, stage outputs as numpy)."""
    if name not in _JAX_RUNS:
        pts, H, W, jcfg = _case(name, tum_cloud, icl_cloud)
        P = min(jcfg.patch_size, H, W)

        @jax.jit
        def run(p):
            stats = jax.vmap(lambda q: jax_compute_cell_stats(q, H, W, jcfg))(p)
            lm, seg = jax.vmap(lambda s: jax_grow_planes(s, jcfg))(stats)
            assoc = jax.vmap(lambda x: jax_plane_adjacency(x, jcfg.max_planes))(lm)
            ml, merged = jax.vmap(lambda x, s: jax_merge_planes(x, s, jcfg))(lm, seg)
            cell = jax.vmap(jax_apply_label_lut)(lm, ml)
            labels = jax.vmap(lambda x, m: jax_rasterize(x, m, H, W, P))(lm, ml)
            return lm, seg, assoc, ml, merged, cell, labels

        cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
        _JAX_RUNS[name] = (H, W, P, cfg, jcfg, jax.device_get(run(jnp.asarray(pts))))
    return _JAX_RUNS[name]


def _assert_merged_close(merged, ref):
    """Merged stats against the reference's, at the stated tolerances."""
    np.testing.assert_allclose(merged.n.numpy(), np.asarray(ref.n), rtol=1e-4)
    np.testing.assert_allclose(merged.normal.numpy(), np.asarray(ref.normal), atol=1e-4)
    np.testing.assert_allclose(merged.mean.numpy(), np.asarray(ref.mean), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(merged.d.numpy(), np.asarray(ref.d), rtol=1e-4, atol=1e-3)
    tr = np.trace(np.asarray(ref.scatter), axis1=-2, axis2=-1)
    assert (np.abs(merged.scatter.numpy() - np.asarray(ref.scatter))
            <= 1e-4 * np.abs(tr)[..., None, None] + 1e-2).all()


@pytest.mark.parametrize("name", ["tum", "icl", "staircases", "empty"])
def test_merge_matches_jax(tum_cloud, icl_cloud, name):
    H, W, P, cfg, _, (lm_j, seg_j, assoc_j, ml_j, merged_j, cell_j, labels_j) = _jax_run(
        name, tum_cloud, icl_cloud)
    lm = torch.from_numpy(np.array(lm_j))
    seg = interop.plane_segments_from_numpy(interop.fields_of(seg_j))

    assoc = merge.plane_adjacency(lm, cfg.max_planes)
    np.testing.assert_array_equal(assoc.numpy(), np.asarray(assoc_j))
    ml, merged = merge.merge_planes_from_adjacency(assoc, seg, cfg)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ml_j))
    _assert_merged_close(merged, merged_j)

    np.testing.assert_array_equal(merge.apply_label_lut(lm, ml).numpy(), np.asarray(cell_j))
    labels = merge.rasterize_labels(lm, ml, H, W, P)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_j))
    if name == "tum":   # the frame's 34 segments merge into 32 planes
        assert int((ml != torch.arange(cfg.max_planes)).sum()) == 2
    if name == "empty":
        np.testing.assert_array_equal(ml.numpy(), np.arange(cfg.max_planes)[None])


@pytest.mark.parametrize("name", ["tum", "icl", "staircases", "empty"])
def test_merge_from_labels_matches_jax(tum_cloud, icl_cloud, name):
    """The stage-4 twin from the cell labels against JAX's vmapped merge_planes."""
    _, _, _, cfg, _, (lm_j, seg_j, _, ml_j, merged_j, _, _) = _jax_run(name, tum_cloud,
                                                                        icl_cloud)
    seg = interop.plane_segments_from_numpy(interop.fields_of(seg_j))
    ml, merged = merge.merge_planes_from_labels(torch.from_numpy(np.array(lm_j)), seg, cfg)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ml_j))
    _assert_merged_close(merged, merged_j)


# Seeded stage-4 cases: (kind, gh, gw, max_planes). Every kind at the serving
# grid with 64 slots, and the other grids and slot counts the kernel serves.
GENERATED = [(kind, 48, 64, 64) for kind in MERGE_KINDS] + [
    ("mixed", 7, 13, 8), ("chain", 120, 160, 100), ("full", 120, 160, 128),
    ("edges", 7, 13, 128)]


def _generated(kind, gh, gw, M, batch=3):
    """A seeded case as (labels_map, port PlaneSegments, JAX PlaneSegments, configs)."""
    from deplex_tpu.ops.growing import PlaneSegments as JaxSegments

    rng = np.random.default_rng(zlib.crc32(f"{kind} {gh}x{gw} m{M}".encode()))
    case = random_merge_case(rng, batch, gh, gw, M, kind)
    lm, seg = merge_case_tensors(case, "cpu")
    jseg = JaxSegments(**{f: jnp.asarray(getattr(seg, f).numpy()) for f in seg._fields})
    return lm, seg, jseg, Config(max_planes=M), JaxConfig(max_planes=M)


@pytest.mark.parametrize("kind,gh,gw,M", GENERATED)
def test_merge_from_labels_matches_jax_on_generated_cases(kind, gh, gw, M):
    lm, seg, jseg, cfg, jcfg = _generated(kind, gh, gw, M)
    ml_j, merged_j = jax.jit(jax.vmap(lambda x, s: jax_merge_planes(x, s, jcfg)))(
        jnp.asarray(lm.numpy()), jseg)
    ml, merged = merge.merge_planes_from_labels(lm, seg, cfg)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ml_j))
    _assert_merged_close(merged, merged_j)
    rows = torch.clamp(seg.nr_planes, max=M)
    assert int((ml != torch.arange(M)).sum()) > 0 or int(rows.max()) == 0


def _assert_matches_pallas(lm, seg, jseg, cfg, jcfg):
    ml_p, merged_p = merge_planes_pallas_batched(jnp.asarray(lm.numpy()), jseg, jcfg,
                                                 interpret=True)
    ml, merged = merge.merge_planes_from_labels(lm, seg, cfg)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ml_p))
    _assert_merged_close(merged, merged_p)


def test_twin_matches_pallas_kernel_on_staircases(tum_cloud, icl_cloud):
    """The twin against the TPU merge kernel itself (interpret mode)."""
    _, _, _, cfg, jcfg, (lm_j, seg_j, _, _, _, _, _) = _jax_run("staircases", tum_cloud,
                                                                 icl_cloud)
    seg = interop.plane_segments_from_numpy(interop.fields_of(seg_j))
    _assert_matches_pallas(torch.from_numpy(np.array(lm_j)), seg, seg_j, cfg, jcfg)


def test_twin_matches_pallas_kernel_on_a_chain():
    """One representative fed over many rows, against the TPU kernel."""
    lm, seg, jseg, cfg, jcfg = _generated("chain", 48, 64, 64, batch=2)
    _assert_matches_pallas(lm, seg, jseg, cfg, jcfg)


def test_wrapper_on_cpu_runs_the_twin():
    lm, seg, _, cfg, _ = _generated("mixed", 48, 64, 64)
    before = kernels.launch_counts()["merge_planes"]
    got = kernels.merge.merge_planes(lm, seg, cfg)
    ref = merge.merge_planes_from_labels(lm, seg, cfg)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    assert kernels.launch_counts()["merge_planes"] == before


@pytest.mark.parametrize("bad", ["labels_int64", "labels_2d", "nr_planes_int64",
                                 "n_float64", "scatter_flat", "slots_mismatch",
                                 "too_many_slots"])
def test_wrapper_rejects_bad_inputs(bad):
    lm, seg, _, cfg, _ = _generated("coplanar", 7, 13, 8, batch=2)
    if bad == "labels_int64":
        lm = lm.long()
    elif bad == "labels_2d":
        lm = lm[0]
    elif bad == "nr_planes_int64":
        seg = seg._replace(nr_planes=seg.nr_planes.long())
    elif bad == "n_float64":
        seg = seg._replace(n=seg.n.double())
    elif bad == "scatter_flat":
        seg = seg._replace(scatter=seg.scatter.reshape(2, 8, 9))
    elif bad == "slots_mismatch":
        cfg = cfg.replace(max_planes=16)
    else:
        cfg = cfg.replace(max_planes=kernels.merge.MAX_SLOTS + 1)
    with pytest.raises(ValueError, match="merge_planes"):
        kernels.merge.merge_planes(lm, seg, cfg)


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
