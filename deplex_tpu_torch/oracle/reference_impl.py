"""Serial numpy oracle for CAPE plane extraction (conformance testing only).

Port of ``deplex_tpu.oracle.reference_impl`` on this package's ``Config``,
with no jax: it re-derives, stage by stage, the observable behavior of the
C++ deplex pipeline (plane_extractor.cpp:187-283) in plain numpy and
float64; each function notes the file:line of the C++ behavior it mirrors.
With the stored goldens it is the reference a machine without jax can hold
the port to. Never on the hot path.
"""

from __future__ import annotations

import collections
import math

import numpy as np

from deplex_tpu_torch.config import Config


class _CellStat:
    """Sufficient statistics + PCA plane fit for a set of points.

    Mirrors CellSegmentStat (cell_segment_stat.cpp:29-81): counts ALL cell
    points (including invalid z==0 rows, which back-project to (0,0,0)).
    """

    def __init__(self, points: np.ndarray | None = None):
        if points is None:
            self.n = 0
            self.coord_sum = np.zeros(3, dtype=np.float64)
            self.variance = np.zeros((3, 3), dtype=np.float64)
            self.mean = np.zeros(3, dtype=np.float64)
            self.mse = np.finfo(np.float32).max
            self.score = 0.0
            self.normal = np.zeros(3, dtype=np.float64)
            self.d = 0.0
            return
        pts = points.astype(np.float64)
        self.n = pts.shape[0]
        self.coord_sum = pts.sum(axis=0)
        self.variance = pts.T @ pts
        self.mean = self.coord_sum / self.n
        self.fit_plane()

    def __iadd__(self, other: "_CellStat"):
        self.n += other.n
        self.coord_sum = self.coord_sum + other.coord_sum
        self.variance = self.variance + other.variance
        self.mean = self.coord_sum / self.n
        return self

    def copy(self) -> "_CellStat":
        out = _CellStat()
        out.n = self.n
        out.coord_sum = self.coord_sum.copy()
        out.variance = self.variance.copy()
        out.mean = self.mean.copy()
        out.mse = self.mse
        out.score = self.score
        out.normal = self.normal.copy()
        out.d = self.d
        return out

    def fit_plane(self):
        # cov = X^T X - sum sum^T / n  (cell_segment_stat.cpp:56)
        cov = self.variance - np.outer(self.coord_sum, self.coord_sum) / self.n
        w, q = np.linalg.eigh(cov)  # ascending eigenvalues
        v = q[:, 0]
        d = -self.mean.dot(v)
        self.normal = v if d > 0 else -v
        self.d = abs(d)
        self.mse = w[0] / self.n
        self.score = w[2] / w.sum()


def _cell_points(points: np.ndarray, H: int, W: int, P: int, cy: int, cx: int) -> np.ndarray:
    """Points of cell (cy, cx), row-major within the cell (cell_grid.cpp:69-83)."""
    img = points.reshape(H, W, 3)
    return img[cy * P : (cy + 1) * P, cx * P : (cx + 1) * P, :].reshape(-1, 3)


def _is_depth_continuous(z: np.ndarray, P: int, thr: float, max_disc: int) -> bool:
    """Mid-row + mid-column carried-prev scans (cell_segment.cpp:62-97).

    z is the flattened (P*P,) depth column of the cell in row-major order.
    The horizontal scan walks LINEAR indices [P*P//2, P*P//2 + P) — for odd P
    this wraps into the next row, matching the reference exactly.
    """
    # Horizontal
    middle = P * P // 2
    prev = z[middle]
    disc = 0
    for i in range(middle, middle + P):
        curr = z[i]
        if curr > 0 and abs(curr - prev) < thr:
            prev = curr
        elif curr > 0:
            disc += 1
    if disc >= max_disc:
        return False
    # Vertical: start at P//2, stride P (cell_segment.cpp:78-90)
    prev = z[P // 2]
    disc = 0
    for i in range(P // 2, P * P, P):
        curr = z[i]
        if curr > 0 and abs(curr - prev) < thr:
            prev = curr
        elif curr > 0:
            disc += 1
    return disc < max_disc


def _merge_tolerance(pts: np.ndarray, cos_angle: float, min_d: float, max_d: float) -> float:
    """clamp(cell_diameter*sin(theta), min_d, max_d)^2 (cell_segment.cpp:104-110)."""
    sin_angle = math.sqrt(1.0 - cos_angle**2)
    diameter = float(np.linalg.norm(pts[0] - pts[-1]))
    return min(max(diameter * sin_angle, min_d), max_d) ** 2


def _histogram_bin(normal: np.ndarray, nr_bins: int) -> int:
    """Spherical-coordinate bin (normals_histogram.cpp:27-48)."""
    nx, ny, nz = float(normal[0]), float(normal[1]), float(normal[2])
    proj = math.sqrt(nx * nx + ny * ny)
    polar = math.acos(max(-1.0, min(1.0, -nz)))
    azimuth = math.atan2(nx / proj, ny / proj) if proj > 0 else 0.0
    xq = int((nr_bins - 1) * polar / math.pi)
    yq = int((nr_bins - 1) * (azimuth + math.pi) / (2 * math.pi)) if xq > 0 else 0
    return yq * nr_bins + xq


def extract_planes_oracle(points: np.ndarray, image_height: int, image_width: int,
                          config: Config | None = None, return_debug: bool = False):
    """Serial oracle of PlaneExtractor::process (plane_extractor.cpp:187-283).

    points: (H*W, 3) organized cloud. Returns (H*W,) int32 labels, 0 = non-planar.
    """
    cfg = config or Config()
    H, W = image_height, image_width
    if points.shape[0] != H * W:
        raise ValueError(
            f"Error! Number of points doesn't match image shape: {points.shape[0]} != {H} x {W}")
    P = min(cfg.patch_size, min(H, W))
    if P == 0:
        raise ValueError("patchSize has to be positive")
    gw, gh = W // P, H // P
    G = gw * gh

    # ---- Stage 1: cell grid (cell_segment.cpp:21-35) ----
    valid_thr = (P * P * 3) // cfg.min_pts_per_cell
    planar = np.zeros(G, dtype=bool)
    stats = [None] * G
    tol = np.zeros(G, dtype=np.float64)
    for cid in range(G):
        cy, cx = cid // gw, cid % gw
        pts = _cell_points(points, H, W, P, cy, cx)
        z = pts[:, 2]
        if (z > 0).sum() < valid_thr:
            continue
        if not _is_depth_continuous(z, P, cfg.depth_discontinuity_threshold,
                                    cfg.max_number_depth_discontinuity):
            continue
        st = _CellStat(pts)
        stats[cid] = st
        thr = cfg.depth_sigma_coeff * st.mean[2] ** 2 + cfg.depth_sigma_margin
        planar[cid] = st.mse <= thr * thr
        # NOTE: min merge dist 20.0 is hardcoded in the reference (cell_segment.cpp:33)
        tol[cid] = _merge_tolerance(pts, cfg.min_cos_angle_merge, 20.0, cfg.max_merge_dist)

    # ---- Stage 2: histogram (normals_histogram.cpp:21-49) ----
    nbins = cfg.histogram_bins_per_coord
    bins = np.full(G, -1, dtype=np.int64)
    hist = np.zeros(nbins * nbins, dtype=np.int64)
    for cid in range(G):
        if planar[cid]:
            b = _histogram_bin(stats[cid].normal, nbins)
            bins[cid] = b
            hist[b] += 1

    # ---- Stage 3: region growing (plane_extractor.cpp:297-392) ----
    unassigned = planar.copy()
    remaining = int(unassigned.sum())
    labels_map = np.zeros(G, dtype=np.int32)
    plane_segments: list[_CellStat] = []

    def neighbours(cid):
        out = []
        x, y = cid // gw, cid % gw
        if x >= 1:
            out.append(cid - gw)
        if x + 1 < gh:
            out.append(cid + gw)
        if y >= 1:
            out.append(cid - 1)
        if y + 1 < gw:
            out.append(cid + 1)
        return out

    while remaining > 0:
        mf_bin = int(np.argmax(hist))
        candidates = [c for c in range(G) if bins[c] == mf_bin] if hist[mf_bin] > 0 else []
        if len(candidates) < cfg.min_region_growing_candidate_size:
            break
        seed_id, min_mse = None, np.inf
        for c in candidates:
            if stats[c].mse < min_mse:
                seed_id, min_mse = c, stats[c].mse
        # BFS growth (growSeed, plane_extractor.cpp:349-392)
        activated = {seed_id}
        queue = collections.deque([seed_id])
        order = [seed_id]
        while queue:
            cur = queue.popleft()
            d_cur = stats[cur].d
            n_cur = stats[cur].normal
            for nb in neighbours(cur):
                if not unassigned[nb] or nb in activated:
                    continue
                cos_angle = n_cur.dot(stats[nb].normal)
                merge_dist = (n_cur.dot(stats[nb].mean) + d_cur) ** 2
                if cos_angle >= cfg.min_cos_angle_merge and merge_dist <= tol[nb]:
                    activated.add(nb)
                    order.append(nb)
                    queue.append(nb)
        # Absorb (plane_extractor.cpp:318-327): candidate starts as a COPY of
        # the seed cell and the seed itself is merged in again from the list.
        cand = stats[seed_id].copy()
        for v in order:
            cand += stats[v]
            hist[bins[v]] -= 1
            bins[v] = -1
            unassigned[v] = False
            remaining -= 1
        if len(order) < cfg.min_region_growing_cells_activated:
            continue
        cand.fit_plane()
        if cand.score > cfg.min_region_planarity_score:
            plane_segments.append(cand)
            for v in order:
                labels_map[v] = len(plane_segments)

    if not plane_segments:
        empty = np.zeros(H * W, dtype=np.int32)
        return (empty, locals()) if return_debug else empty

    # ---- Stage 4: merge (findMergedLabels, plane_extractor.cpp:394-426) ----
    npl = len(plane_segments)
    lm2 = labels_map.reshape(gh, gw)
    assoc = np.zeros((npl, npl), dtype=bool)
    for r in range(gh - 1):
        for c in range(gw - 1):
            pid = lm2[r, c]
            if pid > 0:
                if lm2[r, c + 1] > 0 and pid != lm2[r, c + 1]:
                    assoc[pid - 1, lm2[r, c + 1] - 1] = True
                if lm2[r + 1, c] > 0 and pid != lm2[r + 1, c]:
                    assoc[pid - 1, lm2[r + 1, c] - 1] = True
    assoc |= assoc.T

    merge_labels = list(range(npl))
    for row in range(npl):
        pid = merge_labels[row]
        expanded = False
        for col in range(row + 1, npl):
            if not assoc[row, col]:
                continue
            cos_angle = plane_segments[pid].normal.dot(plane_segments[col].normal)
            dist = (plane_segments[pid].normal.dot(plane_segments[col].mean)
                    + plane_segments[pid].d) ** 2
            if cos_angle > cfg.min_cos_angle_merge and dist < cfg.max_merge_dist:
                plane_segments[pid] += plane_segments[col]
                merge_labels[col] = pid
                expanded = True
            else:
                assoc[row, col] = False
        if expanded:
            plane_segments[pid].fit_plane()

    # ---- Stage 5: rasterize (toImageLabels, plane_extractor.cpp:455-470) ----
    labels = np.zeros(H * W, dtype=np.int32)
    rows = np.arange(H) // P
    cols = np.arange(W) // P
    cell_of_pixel = np.clip(rows[:, None], 0, gh - 1) * gw + np.clip(cols[None, :], 0, gw - 1)
    cell_label = labels_map[cell_of_pixel.reshape(-1)]
    ml = np.asarray([0] + [m + 1 for m in merge_labels], dtype=np.int32)
    labels = ml[cell_label]
    if return_debug:
        return labels, {"planar": planar, "labels_map": labels_map,
                        "plane_segments": plane_segments, "merge_labels": merge_labels,
                        "bins": bins}
    return labels
