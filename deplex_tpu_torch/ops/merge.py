"""Stage 4 — merging adjacent compatible plane segments; stage 5 — labels.

Port of ``deplex_tpu.ops.merge``. Plane adjacency uses the reference's
stencil, which scans rows [0, R-2] and columns [0, C-2] for both the right
and the down neighbour, so the last row and column never contribute.

The greedy merge walks the plane rows in order; within a row the
compatibility tests use the representative's stats as of the start of the
row, and candidate columns always carry their pre-merge stats, so one row is
one masked reduction. On the card the adjacency and the merge are one launch
of the hand kernel ``csrc/merge.cu``; ``merge_planes_from_labels`` below
(``plane_adjacency`` then ``merge_planes_from_adjacency``) is its plain twin.
Stage 5's pixel labels (with stage 6's final inlier pass and the output
dtype) are one launch of ``csrc/labels.cu``; ``pixel_labels_reference``
(``rasterize_labels``, ``ops.ransac.inlier_labels``, the cast) is its twin.
All tensors carry a leading frame axis B.
"""

from __future__ import annotations

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.growing import PlaneSegments, _dot3, fit_plane
from deplex_tpu_torch.ops.ransac import inlier_labels


def plane_adjacency(labels_map: torch.Tensor, max_planes: int) -> torch.Tensor:
    """(B, gh, gw) cell labels -> (B, MAXP, MAXP) bool symmetric adjacency."""
    B = labels_map.shape[0]
    M = max_planes
    lm = labels_map.to(torch.int64)
    a = lm[:, :-1, :-1]
    adj = torch.zeros((B, (M + 1) * (M + 1)), dtype=torch.bool, device=lm.device)
    for other in (lm[:, :-1, 1:], lm[:, 1:, :-1]):
        pair = (a > 0) & (other > 0) & (a != other) & (a <= M) & (other <= M)
        key = torch.where(pair, a * (M + 1) + other, torch.zeros_like(a))
        adj.scatter_(1, key.reshape(B, -1), True)   # same value: order-free
    A = adj.reshape(B, M + 1, M + 1)[:, 1:, 1:]
    return A | A.transpose(1, 2)


def merge_planes_from_adjacency(assoc: torch.Tensor, segments: PlaneSegments,
                                config: Config):
    """The greedy row-by-row merge given the adjacency.

    assoc (B, MAXP, MAXP) bool. Returns (merge_labels (B, MAXP) int32,
    merged PlaneSegments); merge_labels[b, i] is the representative slot of
    plane i (identity if unmerged). Frames advance row by row together.
    """
    B, M = segments.n.shape
    dev = segments.n.device
    min_cos = config.min_cos_angle_merge
    max_dist = config.max_merge_dist
    frames = torch.arange(B, device=dev)
    col_ids = torch.arange(M, device=dev)

    merge_labels = col_ids.to(torch.int32).expand(B, M).clone()
    n = segments.n.clone()
    coord_sum = segments.coord_sum.clone()
    scatter = segments.scatter.clone()
    normal = segments.normal.clone()
    mean = segments.mean.clone()
    d = segments.d.clone()
    nrows = torch.clamp(segments.nr_planes.to(torch.int64), max=M)

    for row in range(int(nrows.max()) if B else 0):
        pid = merge_labels[:, row].to(torch.int64)                     # (B,)
        n_pid = normal[frames, pid]                                     # (B, 3)
        d_pid = d[frames, pid]
        cand = assoc[:, row] & (col_ids > row)[None, :] & (row < nrows)[:, None]
        cos = _dot3(normal, n_pid[:, None, :])
        dist = (_dot3(mean, n_pid[:, None, :]) + d_pid[:, None]) ** 2
        passing = cand & (cos > min_cos) & (dist < max_dist)
        expanded = passing.any(1)

        w = passing.to(torch.float32)
        new_n = n[frames, pid] + (w * n).sum(1)
        new_sum = coord_sum[frames, pid] + torch.einsum("bp,bpi->bi", w, coord_sum)
        mu = new_sum / torch.clamp(new_n, min=1.0)[:, None]
        # Chan k-way combine about the new mean: representative + passing.
        w_all = w + (col_ids[None, :] == pid[:, None]).to(torch.float32)
        dmu = coord_sum / torch.clamp(n, min=1.0)[..., None] - mu[:, None, :]
        new_scatter = (torch.einsum("bp,bpij->bij", w_all, scatter)
                       + torch.einsum("bp,bp,bpi,bpj->bij", w_all, n, dmu, dmu))
        fit_normal, _, fit_d, _, _ = fit_plane(new_scatter, new_sum,
                                               torch.clamp(new_n, min=1.0))

        upd = expanded
        f = frames[upd]
        p = pid[upd]
        n[f, p] = new_n[upd]
        coord_sum[f, p] = new_sum[upd]
        scatter[f, p] = new_scatter[upd]
        # The mean updates at once; normal and d at the end-of-row refit.
        mean[f, p] = mu[upd]
        normal[f, p] = fit_normal[upd]
        d[f, p] = fit_d[upd]
        merge_labels = torch.where(passing, pid[:, None].to(torch.int32), merge_labels)

    merged = PlaneSegments(nr_planes=segments.nr_planes, n=n, coord_sum=coord_sum,
                           scatter=scatter, normal=normal, mean=mean, d=d,
                           mse=segments.mse, score=segments.score)
    return merge_labels, merged


def merge_planes_from_labels(labels_map: torch.Tensor, segments: PlaneSegments,
                             config: Config):
    """Plain twin of the stage-4 kernel: (B, gh, gw) cell labels + batched
    PlaneSegments -> (merge_labels (B, MAXP) int32, merged PlaneSegments)."""
    assoc = plane_adjacency(labels_map, config.max_planes)
    return merge_planes_from_adjacency(assoc, segments, config)


def apply_label_lut(labels_map: torch.Tensor, merge_labels: torch.Tensor) -> torch.Tensor:
    """(B, gh, gw) cell labels -> merged cell labels (a gather), 0 kept."""
    B = labels_map.shape[0]
    lut = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=labels_map.device),
                     merge_labels.to(torch.int32) + 1], dim=1)
    idx = labels_map.reshape(B, -1).to(torch.int64)
    return torch.gather(lut, 1, idx).reshape(labels_map.shape)


def rasterize_labels(labels_map: torch.Tensor, merge_labels: torch.Tensor,
                     image_height: int, image_width: int, patch_size: int) -> torch.Tensor:
    """Stage 5: (B, H*W) int32 pixel labels; merge_labels[cell_label-1] + 1,
    0 for non-planar cells and for the remainder pixels past gh*P, gw*P."""
    B, gh, gw = labels_map.shape
    P = patch_size
    lm = apply_label_lut(labels_map, merge_labels)
    img = lm[:, :, None, :, None].expand(B, gh, P, gw, P).reshape(B, gh * P, gw * P)
    out = torch.zeros((B, image_height, image_width), dtype=torch.int32,
                      device=labels_map.device)
    out[:, :gh * P, :gw * P] = img
    return out.reshape(B, image_height * image_width)


def pixel_labels_reference(labels_map: torch.Tensor, merge_labels: torch.Tensor,
                           image_height: int, image_width: int, patch_size: int,
                           dtype: torch.dtype = torch.int32, refine=None) -> torch.Tensor:
    """Plain twin of the labels kernel: stage 5's (B, H*W) pixel labels in
    `dtype` (uint8 keeps the low 8 bits). refine: stage 6's (points (B, H*W,
    3) float32, best (B, MAXP, 4) float32 winning (n, d) of each plane,
    threshold), whose final pass sets a labelled pixel to 0 unless it is an
    inlier of its plane's winner."""
    labels = rasterize_labels(labels_map, merge_labels, image_height, image_width, patch_size)
    if refine is not None:
        points, best, threshold = refine
        thr = torch.full((), threshold, dtype=torch.float32, device=points.device)
        labels = inlier_labels(points, labels, best[..., :3], best[..., 3], thr)
    return labels.to(dtype)
