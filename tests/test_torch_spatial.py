"""deplex_tpu_torch's spatial sharding (parallel/spatial.py): one frame's cell
grid split by rows over two gloo CPU ranks, held to one process exactly and
to the reference package within tests/test_spatial.py's bounds.

``parallel.launcher`` starts two ranks of ``parallel.verify --spatial``
(which import torch and the port, never jax) per case. Only the cell
statistics cross ranks, and no float is summed across them, so every
rank's labels must equal the port's single-process labels
in every pixel; the reference's own spatial path agrees with its single
device path to >= 0.99 (sums cross its shard boundary). The reference's
spatial path itself is not called here: its sharded compile alone takes
minutes on the CPU mesh (tests/test_spatial.py).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deplex_tpu import Config as JaxConfig
from deplex_tpu.pipeline import extract_planes as jax_extract_planes
from deplex_tpu_torch import Config
from deplex_tpu_torch.parallel import distributed
from deplex_tpu_torch.parallel.launcher import launch
from deplex_tpu_torch.parallel.spatial import CELL_FLOATS, extract_planes_spatial
from deplex_tpu_torch.parallel.verify import load_rank_outputs
from deplex_tpu_torch.pipeline import extract_planes

LAUNCH_TIMEOUT_S = 180


def synthetic_cloud(H, W, seed=0):
    """tests/test_spatial.py's floor + back wall + noise."""
    fx = fy = 500.0
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    u = (np.tile(np.arange(W, dtype=np.float32), (H, 1)) - cx) / fx
    v = (np.tile(np.arange(H, dtype=np.float32)[:, None], (1, W)) - cy) / fy
    z_floor = np.where(v > 0.15, 1000.0 / np.maximum(v, 0.15), np.inf)
    z = np.minimum(z_floor, np.full((H, W), 3000.0, np.float32)).astype(np.float32)
    z += np.random.default_rng(seed).normal(scale=2.0, size=z.shape).astype(np.float32)
    return np.stack([u * z, v * z, z], axis=-1).reshape(-1, 3)


def single_process(pts, H, W, cfg) -> np.ndarray:
    return extract_planes(torch.from_numpy(pts), image_height=H, image_width=W,
                          config=cfg).numpy()


def two_ranks(tmp, pts, H, W, cfg) -> list[dict]:
    np.savez(tmp / "frame.npz", points=pts, height=H, width=W,
             config=json.dumps(dataclasses.asdict(cfg)))
    results = launch([sys.executable, "-m", "deplex_tpu_torch.parallel.verify",
                      "--out", str(tmp / "out"), "--spatial", str(tmp / "frame.npz")],
                     num_processes=2, device="cpu", backend="gloo",
                     extra_env={"OMP_NUM_THREADS": "2"}, timeout=LAUNCH_TIMEOUT_S)
    assert [r.process_id for r in results] == [0, 1]
    return load_rank_outputs(tmp / "out", 2)


CASES = {
    # TUM, the default config: 48 cell rows, 24 a rank.
    "tum": None,
    # 80x160 at P=8: 10 cell rows, 5 a rank, no pad row.
    "synthetic_10_rows": (80, 160, 0),
    # 72x160 at P=8: 9 cell rows, padded to 10 (the last rank holds a pad row).
    "synthetic_9_rows_padded": (72, 160, 1),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tum_cloud):
    out = {}
    for name, case in CASES.items():
        if case is None:
            pts, H, W = tum_cloud
            cfg = Config()
        else:
            H, W, seed = case
            pts, cfg = synthetic_cloud(H, W, seed), Config(patch_size=8, max_planes=16)
        pts = np.ascontiguousarray(pts, np.float32)
        ranks = two_ranks(tmp_path_factory.mktemp(name), pts, H, W, cfg)
        out[name] = (ranks, pts, H, W, cfg)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_equal_one_process(runs, case):
    ranks, pts, H, W, cfg = runs[case]
    ref = single_process(pts, H, W, cfg)
    assert ref.max() > 0
    for o in ranks:
        assert o["labels"].shape == (H * W,) and o["labels"].dtype == np.int32
        np.testing.assert_array_equal(o["labels"], ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_are_cpu_ranks_without_jax(runs, case):
    ranks, _, H, W, cfg = runs[case]
    P = min(cfg.patch_size, H, W)
    per = -(-(H // P) // 2)
    for rank, o in enumerate(ranks):
        assert int(o["world_size"]) == 2 and int(o["rank"]) == rank
        assert str(o["device"]) == "cpu" and not bool(o["jax_imported"])
        # CPU tensors run the plain twins: no kernel launches.
        assert all(int(o[f"launches_{k}"]) == 0
                   for k in ("cell_moments", "grow_rounds", "merge_planes"))
        # One all_gather of every rank's cell table; the labels are not gathered.
        assert int(o["gathered_bytes"]) == 2 * per * (W // P) * CELL_FLOATS * 4


@pytest.mark.parametrize("case", sorted(CASES))
def test_agrees_with_jax_extract_planes(runs, case):
    """tests/test_spatial.py's bounds against the reference's single-device
    pipeline: pixel agreement >= 0.99, plane count within 2."""
    ranks, pts, H, W, cfg = runs[case]
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    ref = np.asarray(jax.jit(lambda p: jax_extract_planes(
        p, image_height=H, image_width=W, config=jcfg))(jnp.asarray(pts)))
    got = ranks[0]["labels"]
    assert float((got == ref).mean()) >= 0.99
    assert abs(np.unique(got[got > 0]).size - np.unique(ref[ref > 0]).size) <= 2


class _Mesh:
    """A 1-D mesh's shape only: the checks run before any collective."""

    mesh_dim_names = ("space",)

    def __init__(self, n):
        self.n = n

    def size(self, dim=None):
        return self.n


def test_refuses_ransac_and_tiny_grids():
    pts = torch.zeros((80 * 96, 3))
    kw = dict(image_height=80, image_width=96, device="cpu")
    with pytest.raises(ValueError, match="ransac"):
        extract_planes_spatial(pts, config=Config(ransac_refinement=True), mesh=_Mesh(2), **kw)
    with pytest.raises(ValueError, match="cell rows"):
        extract_planes_spatial(pts, config=Config(patch_size=40), mesh=_Mesh(4), **kw)


def test_world_of_one_equals_one_process():
    """In one process (a gloo group of one rank) the mesh holds the whole grid."""
    H, W = 80, 160
    pts = synthetic_cloud(H, W, seed=3)
    cfg = Config(patch_size=8, max_planes=16)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        got = extract_planes_spatial(pts, image_height=H, image_width=W, config=cfg,
                                     mesh=distributed.make_mesh("space"), device="cpu")
    finally:
        dist.destroy_process_group()
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), single_process(pts, H, W, cfg))


@pytest.mark.parametrize("given", ["numpy", "cpu_tensor"])
def test_defaults_to_the_card(monkeypatch, given):
    """Without device="cpu" the points go to the card, whatever they are
    given as: with no card the call raises before it reaches the group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = synthetic_cloud(80, 160)
    pts = torch.from_numpy(pts) if given == "cpu_tensor" else pts
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_planes_spatial(pts, image_height=80, image_width=160,
                               config=Config(patch_size=8), mesh=_Mesh(2))
