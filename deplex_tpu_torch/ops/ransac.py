"""Stage 6 — RANSAC plane refinement.

Port of ``deplex_tpu.ops.ransac`` (the reference's ``ransacRefinement``,
RTL::PlaneRANSAC). For every plane, ``ransac_max_iterations`` hypotheses are
made from three random in-plane points and scored by their outlier count
(``|n . x + d| >= ransac_threshold``); the winner follows the reference's
sequential early-exit rule, and pixels that are outliers of their plane's
winner are relabeled 0.

Randomness: the draws are the raw in-plane ranks ``u`` in ``[0, cnt_p)``,
shaped (MAXP, K, 3). ``draw_ranks`` makes them, from an explicit
``torch.Generator`` or by default from a CPU generator seeded 0, kept on the
points' device, so the card and the CPU draw alike and give the same labels.
Other draws are passed to ``refine_labels`` as ``draws=``.
The JAX package draws them with ``jax.random``; fed the same draws, both give
the same labels.

Exactness: losses are integer counts, so every evaluation order picks the
same winner. The distances are formed as ``x*n0 + y*n1 + z*n2 + d`` in
separate elementwise ops (no matmul: no cuBLAS order, no TF32), and each
pixel's hypotheses are selected by indexing with its plane id.
"""

from __future__ import annotations

import functools

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.eigh3x3 import f64_rounded

# Hypotheses scored per chunk of the early-exit loop (the reference package's
# default): one chunk's distances at VGA are a (480, 640, 128) float32 tensor.
DEFAULT_CHUNK = 128


def reference_stop_winner(loss: torch.Tensor, n_points: torch.Tensor,
                          ratio: torch.Tensor) -> torch.Tensor:
    """Index of the reference's early-exit winner given all K losses.

    The reference keeps the running best hypothesis and stops once its
    inlier count reaches ratio * n_points; the winner is the best of the
    hypotheses seen by then (the first on ties)."""
    K = loss.shape[0]
    inliers = n_points - loss
    run_best = torch.cummax(inliers, 0).values
    reached = run_best >= ratio * n_points
    stop = torch.where(reached.any(), torch.argmax(reached.to(torch.int32)),
                       torch.tensor(K - 1, device=loss.device))
    prefix = torch.where(torch.arange(K, device=loss.device) <= stop, loss,
                         torch.full_like(loss, float("inf")))
    return torch.argmin(prefix)


def _fit_3pt_plane(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Unit plane (n, d) through three points; NaN for a degenerate triple.

    The cross product and the dot products are spelled out so that the card
    and the CPU round alike; the norm's sqrt goes through float64."""
    a = p1 - p0
    b = p2 - p0
    n0 = a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]
    n1 = a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2]
    n2 = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    nrm = f64_rounded(torch.sqrt, n0 * n0 + n1 * n1 + n2 * n2)
    n = torch.stack([n0 / nrm, n1 / nrm, n2 / nrm], dim=-1)
    d = -(n[..., 0] * p0[..., 0] + n[..., 1] * p0[..., 1] + n[..., 2] * p0[..., 2])
    return n, d


def _raw_draws(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 2 ** 31 - 1, shape, generator=generator, device=generator.device)


@functools.lru_cache(maxsize=8)
def _seeded_raw_draws(shape: tuple, device: torch.device) -> torch.Tensor:
    """The default stream, drawn once on the CPU and kept on `device`: every
    frame draws the same raw numbers (the reference package gives every frame
    the same key), and no frame pays a host-to-device copy."""
    return _raw_draws(shape, torch.Generator().manual_seed(0)).to(device)


def draw_ranks(counts: torch.Tensor, iterations: int,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """(MAXP,) in-plane point counts -> (MAXP, K, 3) int64 ranks in
    [0, max(cnt, 1)) on the counts' device, from `generator` (by default a
    CPU generator seeded 0, whatever the device)."""
    shape = (counts.shape[0], iterations, 3)
    raw = (_seeded_raw_draws(shape, counts.device) if generator is None
           else _raw_draws(shape, generator).to(counts.device))
    return raw % torch.clamp(counts.to(torch.int64), min=1)[:, None, None]


def _distinct(u: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The reference package's de-duplicating shift of three ranks."""
    c = torch.clamp(counts, min=1)[:, None]
    u0, u1, u2 = u.unbind(-1)
    u1 = u1 + (u1 == u0)
    u2 = u2 + (u2 == u0) + (u2 == u1)
    return torch.stack([u0, u1 % c, u2 % c], dim=-1)


def _group_bounds(ids: torch.Tensor, max_planes: int):
    """Stable order of `ids` and, per id 0..MAXP, its count and offset."""
    order = torch.argsort(ids, stable=True)
    marks = torch.arange(max_planes + 2, dtype=ids.dtype, device=ids.device)
    bounds = torch.searchsorted(ids[order].contiguous(), marks)
    return order, bounds.diff(), bounds[:-1]


def _sanitize(n: torch.Tensor, d: torch.Tensor, padded: int):
    """Pad the hypothesis axis to `padded` and turn degenerate (non-finite)
    models into an all-outlier finite one (n = 0, d = 1e30)."""
    P, K = d.shape
    if padded > K:
        n = torch.cat([n, torch.full((P, padded - K, 3), float("nan"),
                                     dtype=n.dtype, device=n.device)], 1)
        d = torch.cat([d, torch.full((P, padded - K), float("nan"),
                                     dtype=d.dtype, device=d.device)], 1)
    bad = ~(torch.isfinite(d) & torch.isfinite(n).all(-1))
    n = torch.where(bad[..., None], torch.zeros_like(n), n)
    d = torch.where(bad, torch.full_like(d, 1e30), d)
    return n, d


def _outliers(x, y, z, nsel, dsel, thr):
    """Outlier mask |x*n0 + y*n1 + z*n2 + d| >= thr (non-finite: outlier),
    one elementwise op at a time, in the reference package's order."""
    e = x * nsel[..., 0]
    e += y * nsel[..., 1]
    e += z * nsel[..., 2]
    e += dsel
    return ~(torch.abs(e) < thr)


def _early_exit_winners(chunk_losses, n_pts, ratio, n_chunks: int, chunk: int):
    """The reference's early-exit rule over chunks of hypotheses.

    chunk_losses(s) -> (MAXP, Kc) float32 outlier counts of chunk s. A plane
    that reached its target is frozen; the loop ends when all have (one host
    sync per chunk). Returns each plane's winning hypothesis index."""
    dev = n_pts.device
    MAXP = n_pts.shape[0]
    target = ratio * n_pts
    cols = torch.arange(chunk, device=dev)
    reached = torch.zeros(MAXP, dtype=torch.bool, device=dev)
    run_best = torch.full((MAXP,), float("-inf"), device=dev)
    best_loss = torch.full((MAXP,), float("inf"), device=dev)
    best_k = torch.zeros(MAXP, dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for s in range(n_chunks):
        loss = chunk_losses(s)
        inliers = n_pts[:, None] - loss
        run = torch.cummax(torch.maximum(inliers, run_best[:, None]), 1).values
        hit = run >= target[:, None]
        any_hit = hit.any(1)
        stop = torch.where(any_hit, torch.argmax(hit.to(torch.int32), 1),
                           torch.full_like(best_k, chunk - 1))
        prefix = torch.where(cols[None, :] <= stop[:, None], loss, inf)
        j = torch.argmin(prefix, 1)
        pl = torch.gather(prefix, 1, j[:, None])[:, 0]
        # Strict < keeps the first global minimum (the argmin tie rule).
        upd = (~reached) & (pl < best_loss)
        best_loss = torch.where(upd, pl, best_loss)
        best_k = torch.where(upd, s * chunk + j, best_k)
        reached = reached | any_hit
        run_best = torch.maximum(run_best, run[:, -1])
        if bool(reached.all()):
            break
    return best_k


def refine_labels(points: torch.Tensor, labels: torch.Tensor, config: Config, *,
                  draws: torch.Tensor | None = None,
                  cell_labels: torch.Tensor | None = None,
                  image_width: int | None = None,
                  patch_size: int | None = None,
                  chunk_size: int | None = None) -> torch.Tensor:
    """points (N, 3), labels (N,) int -> refined (N,) int32 labels.

    cell_labels (gh, gw) with image_width and patch_size: the final per-cell
    plane ids. Stage 5 labels whole cells, so sampling a plane pixel is
    sampling a plane cell, then a pixel in it; sampling and scoring then run
    over the cell grid. Without it (arbitrary pixel labels) the planes'
    pixels are grouped by a stable argsort of all N labels.

    draws (MAXP, K, 3) int: raw ranks in [0, cnt_p) that replace the
    default stream of `draw_ranks` (cnt_p = the pixel count of plane p+1)."""
    dev = points.device
    N = points.shape[0]
    MAXP = config.max_planes
    K = config.ransac_max_iterations
    thr = torch.tensor(config.ransac_threshold, dtype=torch.float32, device=dev)
    ratio = torch.tensor(config.ransac_inliers_ratio, dtype=torch.float32, device=dev)
    pts = points.to(torch.float32)
    plane_ids = torch.arange(1, MAXP + 1, device=dev)
    labels = labels.to(torch.int64)

    if cell_labels is not None:
        gh, gw = cell_labels.shape
        P, W, PP, G = patch_size, image_width, patch_size * patch_size, gh * gw
        cl = cell_labels.reshape(-1).to(torch.int64)
        cell_order, ccounts, coffsets = _group_bounds(cl, MAXP)
        counts = ccounts[plane_ids] * PP
        u = draws if draws is not None else draw_ranks(counts, K)
        idx = _distinct(u.to(dev, torch.int64), counts)
        crank, t = idx // PP, idx % PP
        cell = cell_order[torch.clamp(coffsets[plane_ids][:, None, None] + crank, 0, G - 1)]
        pix = ((cell // gw) * P + t // P) * W + ((cell % gw) * P + t % P)
    else:
        order, pcounts, offsets = _group_bounds(labels, MAXP)
        counts = pcounts[plane_ids]
        u = draws if draws is not None else draw_ranks(counts, K)
        idx = _distinct(u.to(dev, torch.int64), counts)
        pix = order[torch.clamp(offsets[plane_ids][:, None, None] + idx, 0, N - 1)]
    tri = pts[pix]                                            # (MAXP, K, 3, 3)
    n_hyp, d_hyp = _fit_3pt_plane(tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])

    Kc = min(K, chunk_size or DEFAULT_CHUNK)
    S = (K + Kc - 1) // Kc
    n_all, d_all = _sanitize(n_hyp, d_hyp, S * Kc)

    def table(s):
        """Chunk s's hypotheses with a leading row for id 0 (no plane)."""
        nck = n_all[:, s * Kc:(s + 1) * Kc]
        dck = d_all[:, s * Kc:(s + 1) * Kc]
        return (torch.cat([torch.zeros_like(nck[:1]), nck]),
                torch.cat([torch.zeros_like(dck[:1]), dck]))

    if cell_labels is not None:
        # Each pixel is scored against its own cell's plane only, over the
        # free (gh, P, gw, P) view of the frame.
        img = pts.reshape(N // W, W, 3)[: gh * P, : gw * P]
        x4, y4, z4 = (img[..., i].reshape(gh, P, gw, P, 1) for i in range(3))
        group = cl
        n_pts = (torch.bincount(cl, minlength=MAXP + 1)[1:MAXP + 1] * PP).to(torch.float32)

        def outlier_counts(s):
            n_tab, d_tab = table(s)
            nsel = n_tab[cl].reshape(gh, 1, gw, 1, Kc, 3)
            dsel = d_tab[cl].reshape(gh, 1, gw, 1, Kc)
            out = _outliers(x4, y4, z4, nsel, dsel, thr)
            return out.sum((1, 3)).reshape(G, Kc)
    else:
        group = torch.where((labels >= 1) & (labels <= MAXP), labels,
                            torch.zeros_like(labels))
        n_pts = torch.bincount(group, minlength=MAXP + 1)[1:MAXP + 1].to(torch.float32)
        x, y, z = (pts[:, i:i + 1] for i in range(3))

        def outlier_counts(s):
            n_tab, d_tab = table(s)
            return _outliers(x, y, z, n_tab[group], d_tab[group], thr)

    def chunk_losses(s):
        # Id-0 rows collect the unlabeled pixels and are dropped; the counts
        # are integers in float32, exact in any order.
        acc = torch.zeros((MAXP + 1, Kc), dtype=torch.float32, device=dev)
        acc.index_add_(0, group, outlier_counts(s).to(torch.float32))
        return acc[1:]

    best_k = _early_exit_winners(chunk_losses, n_pts, ratio, S, Kc)
    rows = torch.arange(MAXP, device=dev)
    best_n = n_all[rows, best_k]                              # (MAXP, 3)
    best_d = d_all[rows, best_k]

    # Final inlier pass: a labeled pixel keeps its label iff it is an inlier
    # of its plane's winning model.
    lbl = torch.clamp(labels - 1, 0, MAXP - 1)
    n_pix = best_n[lbl]
    err = pts[:, 0] * n_pix[:, 0]
    err += pts[:, 1] * n_pix[:, 1]
    err += pts[:, 2] * n_pix[:, 2]
    err += best_d[lbl]
    keep = torch.abs(err) < thr
    return torch.where((labels > 0) & ~keep, torch.zeros_like(labels),
                       labels).to(torch.int32)


def refine_batch(points: torch.Tensor, labels: torch.Tensor, cell_labels: torch.Tensor,
                 image_width: int, patch_size: int, config: Config) -> torch.Tensor:
    """Stage 6 for a batch, one frame at a time (bounds the peak memory to
    one frame's chunk): (B, N, 3) points, (B, N) labels, (B, gh, gw) cell
    labels -> (B, N) int32. Every frame draws from the default stream, as
    the reference package gives every frame of a batch the same key."""
    return torch.stack([
        refine_labels(points[b], labels[b], config, cell_labels=cell_labels[b],
                      image_width=image_width, patch_size=patch_size)
        for b in range(points.shape[0])])
