"""Synthetic organized point clouds with known primitives (numpy).

The scenes of the reference package's cylinder tests, for the port's tests
and ``chip_smoke.py``: ``cylinder_scene`` (tests/test_cylinder.py, 240x320)
and ``hires_scene`` (tests/test_stress.py, 1280x720: floor, two walls,
sensor noise from seed 0, and a horizontal cylinder in front).
"""

from __future__ import annotations

import numpy as np


def _cylinder_depth(u, dv, z0: float, r: float):
    """Ray parameter of the first hit of the rays (u, dv, 1) with the
    cylinder y^2 + (z - z0)^2 = r^2 (axis x), inf where they miss."""
    a = dv * dv + 1.0
    disc = (2.0 * z0) ** 2 - 4 * a * (z0 * z0 - r * r)
    return np.where(disc > 0, (2.0 * z0 - np.sqrt(np.maximum(disc, 0))) / (2 * a), np.inf)


def cylinder_scene(H: int = 240, W: int = 320, r: float = 400.0, z0: float = 2000.0,
                   z_bg: float = 4000.0):
    """A horizontal cylinder (axis x, radius r, axis at depth z0) in front of
    a back wall at z_bg. Returns ((H*W, 3) float32 points, H, W)."""
    f = 260.0
    u = (np.arange(W, dtype=np.float64) - (W / 2 - 0.5)) / f
    dv = np.broadcast_to((np.arange(H, dtype=np.float64)[:, None] - (H / 2 - 0.5)) / f, (H, W))
    t = _cylinder_depth(u, dv, z0, r)
    z = np.minimum(np.where(np.isfinite(t), t, z_bg), z_bg)
    pts = np.stack([np.broadcast_to(u, (H, W)) * z, dv * z, z], -1)
    return pts.reshape(-1, 3).astype(np.float32), H, W


def hires_scene(z0: float = 2500.0, r: float = 400.0):
    """1280x720 (f = 1000): floor at y = 1000 mm, back wall at z = 4000,
    side wall at x = 1500, Gaussian depth noise (2 mm, seed 0), and a
    horizontal cylinder (radius r, axis at depth z0) where it is nearer.
    Returns ((H*W, 3) float32 points, H, W)."""
    H, W = 720, 1280
    f = 1000.0
    u32 = (np.tile(np.arange(W, dtype=np.float32), (H, 1)) - (W / 2 - 0.5)) / f
    v32 = (np.tile(np.arange(H, dtype=np.float32)[:, None], (1, W)) - (H / 2 - 0.5)) / f
    z_floor = np.where(v32 > 0.15, 1000.0 / np.maximum(v32, 0.15), np.inf)
    z_side = np.where(u32 > 0.15, 1500.0 / np.maximum(u32, 0.15), np.inf)
    z = np.minimum(np.minimum(z_floor, np.full((H, W), 4000.0, np.float32)),
                   z_side).astype(np.float32)
    z += np.random.default_rng(0).normal(scale=2.0, size=z.shape).astype(np.float32)
    u = (np.arange(W, dtype=np.float64) - (W / 2 - 0.5)) / f
    dv = np.broadcast_to(((np.arange(H, dtype=np.float64) - (H / 2 - 0.5)) / f)[:, None], (H, W))
    t = _cylinder_depth(u, dv, z0, r)
    z = np.where(np.isfinite(t) & (t < z), t, z).astype(np.float32)
    pts = np.stack([np.broadcast_to(u, (H, W)) * z, dv * z, z], -1).astype(np.float32)
    return pts.reshape(-1, 3), H, W
