"""The SLAM cells' depth sequences: one depth frame warped along a smooth
seeded camera trajectory, with the exact poses.

The benchmark's own copy of the port's ``utils/warp.py``
(``smooth_trajectory``, ``render_sequence`` and the warp under them) and of
``tools/make_sequence.sequence_frames`` (the frames rounded and clipped to
uint16, as they are written to PNG), so that a change to the program's
warp cannot change a cell's inputs. numpy only, in the same operations and
order as the port's, so the frames are bit for bit the port's
(``tests/test_torch_slam_cell.py`` holds them to it).

A recorded sequence is not in the repository; one frame warped this way
gives realistic holes and resampling noise, and ground truth.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np


def warp_depth(depth: np.ndarray, K: np.ndarray, R: np.ndarray,
               t: np.ndarray, *, vis_window: float = 300.0) -> np.ndarray:
    """The depth seen from camera pose (R, t) (camera-from-world, world =
    the original camera frame): bilinear point splatting with z-buffered
    visibility (the nearest z over each splat's four pixels, then the
    bilinear-weighted mean of the samples within `vis_window` of it), then
    ``_refine_inverse``. depth: (H, W) raw units (0 = invalid); K: 3x3."""
    H, W = depth.shape
    fx, cx = K[0, 0], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    z = depth.astype(np.float32)
    valid = z > 0
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = np.stack([x[valid], y[valid], z[valid]], 1)
    pc = pts @ R.T + t
    zc = pc[:, 2]
    front = zc > 100
    pc = pc[front]
    zc = zc[front]
    uf = pc[:, 0] / zc * fx + cx
    vf = pc[:, 1] / zc * fy + cy

    u0 = np.floor(uf).astype(np.int64)
    v0 = np.floor(vf).astype(np.int64)
    au = uf - u0
    av = vf - v0

    zmin = np.full(H * W, np.inf, np.float32)
    corners = []
    for du, dv, w in ((0, 0, (1 - au) * (1 - av)), (1, 0, au * (1 - av)),
                      (0, 1, (1 - au) * av), (1, 1, au * av)):
        ui = u0 + du
        vi = v0 + dv
        ok = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (w > 1e-3)
        flat = vi[ok] * W + ui[ok]
        corners.append((flat, zc[ok], w[ok].astype(np.float32)))
        np.minimum.at(zmin, flat, zc[ok])

    wsum = np.zeros(H * W, np.float32)
    wz = np.zeros(H * W, np.float32)
    for flat, zs, ws in corners:
        visible = zs <= zmin[flat] + vis_window
        np.add.at(wsum, flat[visible], ws[visible])
        np.add.at(wz, flat[visible], ws[visible] * zs[visible])
    out = np.where(wsum > 0, wz / np.maximum(wsum, 1e-12), 0.0)
    out = out.reshape(H, W).astype(np.float32)
    return _refine_inverse(out, depth, K, R, t, vis_window)


def _refine_inverse(z0: np.ndarray, depth: np.ndarray, K: np.ndarray,
                    R: np.ndarray, t: np.ndarray, vis_window: float,
                    iterations: int = 3) -> np.ndarray:
    """Each valid target pixel fixed by backward mapping: unproject with the
    current z, move to the source camera, sample the source depth
    bilinearly and transform back; three fixed-point iterations. Samples
    whose four source pixels hold a hole or span more than `vis_window`
    keep the splatted value."""
    H, W = z0.shape
    fx, cx = K[0, 0], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    Rinv = R.T
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    zsrc = depth.astype(np.float32)
    valid0 = z0 > 0
    z = z0.copy()
    for _ in range(iterations):
        x = (u - cx) * z / fx
        y = (v - cy) * z / fy
        pw = np.stack([x, y, z], -1) @ Rinv.T - (Rinv @ t)
        zs = pw[..., 2]
        ok = valid0 & (zs > 100)
        us = np.where(ok, pw[..., 0] / np.maximum(zs, 1e-6) * fx + cx, 0.0)
        vs = np.where(ok, pw[..., 1] / np.maximum(zs, 1e-6) * fy + cy, 0.0)
        u0 = np.floor(us).astype(np.int64)
        v0f = np.floor(vs).astype(np.int64)
        inb = ok & (u0 >= 0) & (u0 + 1 < W) & (v0f >= 0) & (v0f + 1 < H)
        u0c = np.clip(u0, 0, W - 2)
        v0c = np.clip(v0f, 0, H - 2)
        au = us - u0c
        av = vs - v0c
        q00 = zsrc[v0c, u0c]
        q10 = zsrc[v0c, u0c + 1]
        q01 = zsrc[v0c + 1, u0c]
        q11 = zsrc[v0c + 1, u0c + 1]
        quad = np.stack([q00, q10, q01, q11])
        flat = inb & (quad.min(0) > 0) & (quad.max(0) - quad.min(0) < vis_window)
        z_interp = ((1 - au) * (1 - av) * q00 + au * (1 - av) * q10
                    + (1 - au) * av * q01 + au * av * q11)
        xs = (us - cx) * z_interp / fx
        ys = (vs - cy) * z_interp / fy
        pt = np.stack([xs, ys, z_interp], -1) @ R.T + t
        z = np.where(flat & (pt[..., 2] > 100), pt[..., 2], z).astype(np.float32)
    return z


def _rodrigues(phi: np.ndarray) -> np.ndarray:
    """SO(3) exp in plain numpy."""
    theta = float(np.linalg.norm(phi))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = phi / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]],
                 np.float64)
    R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    return R.astype(np.float32)


def smooth_trajectory(n_frames: int, *, rot_step: float = 0.002,
                      trans_step=(8.0, 3.0, 12.0), seed: int = 0):
    """Camera-from-world poses [(R, t)] of a slow drifting camera, pose 0
    the identity: each step a seeded rotation of `rot_step` radians' scale
    and a fixed translation of `trans_step` mm."""
    rng = np.random.default_rng(seed)
    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    step = np.asarray(trans_step, np.float32)
    for _ in range(1, n_frames):
        dR = _rodrigues((rng.normal(size=3) * rot_step).astype(np.float32))
        R = (dR @ poses[-1][0]).astype(np.float32)
        t = (poses[-1][1] + step).astype(np.float32)
        poses.append((R, t))
    return poses


def render_sequence(depth0: np.ndarray, K: np.ndarray, poses) -> list[np.ndarray]:
    """depth0 warped into every pose; pose 0 (identity) is depth0 as is."""
    frames = []
    for i, (R, t) in enumerate(poses):
        if i == 0 and np.allclose(R, np.eye(3)) and np.allclose(t, 0):
            frames.append(depth0.astype(np.float32))
        else:
            frames.append(warp_depth(depth0, K, R, t))
    return frames


def sequence_frames(depth0: np.ndarray, K, frames: int, seed: int = 0):
    """(uint16 frames, poses): depth0 warped along smooth_trajectory(frames,
    seed), rounded and clipped to uint16."""
    poses = smooth_trajectory(frames, seed=seed)
    rendered = render_sequence(depth0, np.asarray(K, np.float32), poses)
    return [np.clip(np.round(d), 0, 65535).astype(np.uint16) for d in rendered], poses


def sequence_seeds(seed: int, n: int) -> list[int]:
    """n distinct trajectory seeds drawn from a run's `seed`."""
    rng = np.random.default_rng(seed % 2 ** 64)
    return [int(s) for s in rng.choice(2 ** 31, size=n, replace=False)]


def sequences(depth0: np.ndarray, K, frames: int, seeds: list[int]) -> list[list[np.ndarray]]:
    """The uint16 frames of one sequence a seed, the sequences rendered side
    by side on the host's threads (numpy's array work releases the GIL)."""
    with ThreadPoolExecutor(max_workers=len(seeds)) as pool:
        return list(pool.map(lambda s: sequence_frames(depth0, K, frames, s)[0], seeds))
