"""Stage 6 — RANSAC plane refinement.

Port of ``deplex_tpu.ops.ransac`` (the reference's ``ransacRefinement``,
RTL::PlaneRANSAC). For every plane, ``ransac_max_iterations`` hypotheses are
made from three random in-plane points and scored by their outlier count
(``|n . x + d| >= ransac_threshold``); the winner follows the reference's
sequential early-exit rule, and pixels that are outliers of their plane's
winner are relabeled 0.

The batch form, ``refine_cells``, samples and scores over the cell grid that
stage 5 labels, for (B, MAXP) planes at once. Sampling, ``sample(...)``,
merges the cell labels, orders the cells by plane, draws and fits the
hypotheses and makes the loop's first state (``sample_stage_reference``
here; the pipeline passes the kernels of ``csrc/sampling.cu``, which do
all of it in two launches, a sort and the fits). It scores the K
hypotheses in
S = ceil(K / Kc) chunks of Kc. One chunk step, ``step(s, state)``, counts
every plane's outliers of chunk s and applies the reference's early-exit
update to a ``ChunkState``, a set of tensors updated in place
(``chunk_step_reference`` here; the pipeline passes the kernel of
``csrc/ransac.cu``, which does both in one launch and which this module
never imports). A frame whose planes have all reached their target is done:
its chunks score nothing and its state is frozen, as the reference
package's vmapped ``while_loop`` freezes a finished frame's carry, and a
plane that reached its target is frozen too, so the winners are those of
that ``while_loop``. On a card the loop runs all S chunks and the early exit
happens on the device (nothing waits on the host, so a CUDA graph records
the loop); on the CPU it stops once every frame is done. The final pass
over the pixels (``inlier_labels``) is, on the pipeline's path, stage 5's
labels kernel (``csrc/labels.cu``), which writes the refined labels from the
cell labels and the winners (read from the hypotheses at ``best_k``) in one
launch (``refine_cells``' ``write``).

Randomness: the draws are the raw in-plane ranks ``u`` in ``[0, cnt_p)``,
shaped (MAXP, K, 3), the same for every frame of a batch (the reference
package gives every frame the same key). ``draw_ranks`` makes them from raw
numbers: an explicit ``torch.Generator``'s, or by default a CPU generator's
seeded 0 (``default_draws``, kept on the points' device), so the card and
the CPU draw alike and give the same labels. Other draws are passed as
``draws=``. The JAX package draws them with ``jax.random``; fed the same
draws, both give the same labels.

Exactness: losses are integer counts, so every evaluation order picks the
same winner. The distances are formed as ``x*n0 + y*n1 + z*n2 + d`` in
separate elementwise ops (no matmul: no cuBLAS order, no TF32), and each
pixel's hypotheses are selected by indexing with its plane id.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.eigh3x3 import f64_rounded

# Hypotheses scored per chunk of the early-exit loop (the reference package's
# default).
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
                       torch.full((), K - 1, dtype=torch.int64, device=loss.device))
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
    frame draws the same raw numbers, and no frame pays a host-to-device
    copy."""
    return _raw_draws(shape, torch.Generator().manual_seed(0)).to(device)


def default_draws(config: Config, device) -> torch.Tensor:
    """The default stream's (MAXP, K, 3) int64 raw numbers on `device`. A
    compiled entry point takes them as an input of its graph, so that the
    graph never reads a tensor this cache may drop."""
    return _seeded_raw_draws((config.max_planes, config.ransac_max_iterations, 3),
                             torch.device(device))


def draw_ranks(counts: torch.Tensor, iterations: int,
               generator: torch.Generator | None = None, *,
               raw: torch.Tensor | None = None) -> torch.Tensor:
    """(..., MAXP) in-plane point counts -> (..., MAXP, K, 3) int64 ranks in
    [0, max(cnt, 1)) on the counts' device: from the (MAXP, K, 3) `raw`
    numbers, else from `generator` (by default a CPU generator seeded 0,
    whatever the device). Every frame takes the same raw numbers."""
    if raw is None:
        shape = (counts.shape[-1], iterations, 3)
        raw = (_seeded_raw_draws(shape, counts.device) if generator is None
               else _raw_draws(shape, generator).to(counts.device))
    return raw % torch.clamp(counts.to(torch.int64), min=1)[..., None, None]


def _distinct(u: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The reference package's de-duplicating shift of three ranks."""
    c = torch.clamp(counts, min=1)[..., None]
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
    """Pad the hypothesis axis (d's last) to `padded` and turn degenerate
    (non-finite) models into an all-outlier finite one (n = 0, d = 1e30)."""
    K = d.shape[-1]
    if padded > K:
        n = torch.cat([n, n.new_full((*n.shape[:-2], padded - K, 3), float("nan"))], -2)
        d = torch.cat([d, d.new_full((*d.shape[:-1], padded - K), float("nan"))], -1)
    bad = ~(torch.isfinite(d) & torch.isfinite(n).all(-1))
    n = torch.where(bad[..., None], torch.zeros_like(n), n)
    d = torch.where(bad, torch.full_like(d, 1e30), d)
    return n.contiguous(), d.contiguous()


def _outliers(x, y, z, nsel, dsel, thr):
    """Outlier mask |x*n0 + y*n1 + z*n2 + d| >= thr (non-finite: outlier),
    one elementwise op at a time, in the reference package's order."""
    e = x * nsel[..., 0]
    e += y * nsel[..., 1]
    e += z * nsel[..., 2]
    e += dsel
    return ~(torch.abs(e) < thr)


def chunk_outliers_reference(points: torch.Tensor, cell_labels: torch.Tensor,
                             n_tab: torch.Tensor, d_tab: torch.Tensor, done: torch.Tensor,
                             scored: torch.Tensor, *, s: int, chunk: int, threshold: float,
                             image_width: int, patch_size: int) -> torch.Tensor:
    """Outlier counts of hypothesis chunk s: the counting half of
    ``chunk_step_reference``, the plain twin of ``csrc/ransac.cu``.

    points (B, H*W, 3) float32; cell_labels (B, gh, gw) plane ids (0 =
    none); n_tab (B, MAXP, S*Kc, 3) and d_tab (B, MAXP, S*Kc) the sanitized
    hypotheses; done (B,) bool. Returns (B, MAXP, Kc) int32: for plane p
    and hypothesis k of the chunk, the outliers among the pixels of p's
    cells (each pixel scored against its own cell's plane, inside the gh*P
    x gw*P crop), 0 for a done frame. Adds 1 to scored[b] for each frame b
    that is not done."""
    B, gh, gw = cell_labels.shape
    MAXP = n_tab.shape[1]
    P, W, Kc, G = patch_size, image_width, chunk, gh * gw
    dev = points.device
    thr = torch.full((), threshold, dtype=torch.float32, device=dev)
    img = points.reshape(B, -1, W, 3)[:, :gh * P, :gw * P]
    cl = cell_labels.reshape(B, G).to(torch.int64)
    cl = torch.where((cl >= 1) & (cl <= MAXP), cl, torch.zeros_like(cl))
    # A leading row for id 0 (no plane): its counts are dropped.
    nck = n_tab[:, :, s * Kc:(s + 1) * Kc]
    dck = d_tab[:, :, s * Kc:(s + 1) * Kc]
    n0 = torch.cat([torch.zeros_like(nck[:, :1]), nck], 1)
    d0 = torch.cat([torch.zeros_like(dck[:, :1]), dck], 1)
    acc = torch.zeros((B, MAXP + 1, Kc), dtype=torch.int64, device=dev)
    for b in range(B):      # one frame's (gh*P, gw*P, Kc) distances at a time
        x4, y4, z4 = (img[b, ..., i].reshape(gh, P, gw, P, 1) for i in range(3))
        nsel = n0[b][cl[b]].reshape(gh, 1, gw, 1, Kc, 3)
        dsel = d0[b][cl[b]].reshape(gh, 1, gw, 1, Kc)
        out = _outliers(x4, y4, z4, nsel, dsel, thr)
        acc[b].index_add_(0, cl[b], out.sum((1, 3)).reshape(G, Kc))
    scored += (~done).to(scored.dtype)
    counts = acc[:, 1:].to(torch.int32)
    return torch.where(done[:, None, None], torch.zeros_like(counts), counts)


class ChunkState(NamedTuple):
    """The early-exit loop's state for (B, MAXP) planes with Kc hypotheses a
    chunk: one set of tensors that every chunk step updates in place, the
    kernel's and the twin's alike."""
    n_pts: torch.Tensor      # (B, MAXP) float32 pixels a plane
    target: torch.Tensor     # (B, MAXP) float32 inliers that stop: ratio * n_pts
    reached: torch.Tensor    # (B, MAXP) bool: the plane hit its target
    run_best: torch.Tensor   # (B, MAXP) float32 most inliers seen
    best_loss: torch.Tensor  # (B, MAXP) float32 the winner's outliers
    best_k: torch.Tensor     # (B, MAXP) int64 the winner's index
    done: torch.Tensor       # (B,) bool: every plane of the frame reached
    scored: torch.Tensor     # (B,) int32 chunks scored
    counts: torch.Tensor     # (B, MAXP, Kc) int32 the kernel's sums, 0 between steps
    tickets: torch.Tensor    # (B,) int32 the kernel's blocks done, 0 between steps


def new_chunk_state(n_pts: torch.Tensor, ratio: torch.Tensor, chunk: int) -> ChunkState:
    """The state before chunk 0 for planes of n_pts (B, MAXP) float32
    pixels, on their device; ratio is a 0-d float32 tensor there."""
    B, MAXP = n_pts.shape
    dev = n_pts.device
    return ChunkState(
        n_pts=n_pts, target=ratio * n_pts,
        reached=torch.zeros((B, MAXP), dtype=torch.bool, device=dev),
        run_best=torch.full((B, MAXP), float("-inf"), device=dev),
        best_loss=torch.full((B, MAXP), float("inf"), device=dev),
        best_k=torch.zeros((B, MAXP), dtype=torch.int64, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        scored=torch.zeros((B,), dtype=torch.int32, device=dev),
        counts=torch.zeros((B, MAXP, chunk), dtype=torch.int32, device=dev),
        tickets=torch.zeros((B,), dtype=torch.int32, device=dev))


def _apply_chunk(state: ChunkState, counts: torch.Tensor, live: torch.Tensor, s: int,
                 chunk: int) -> None:
    """The reference's early-exit update for chunk s's (B, MAXP, Kc)
    outlier counts, on the frames `live` (B,) marks: the running best
    inliers, the first hypothesis that reaches the target (else the last),
    the best of the prefix up to it (the first on ties), a winner kept by
    planes reached before; then done[b] for the next chunk. Other frames
    keep their state."""
    loss = counts.to(torch.float32)
    inliers = state.n_pts[..., None] - loss
    run = torch.cummax(torch.maximum(inliers, state.run_best[..., None]), 2).values
    hit = run >= state.target[..., None]
    any_hit = hit.any(2)
    stop = torch.where(any_hit, torch.argmax(hit.to(torch.int32), 2),
                       torch.full_like(state.best_k, chunk - 1))
    cols = torch.arange(chunk, device=counts.device)
    prefix = torch.where(cols <= stop[..., None], loss, torch.full_like(loss, float("inf")))
    j = torch.argmin(prefix, 2)
    pl = torch.gather(prefix, 2, j[..., None])[..., 0]
    live = live[:, None]
    # Strict < keeps the first global minimum (the argmin tie rule).
    upd = live & ~state.reached & (pl < state.best_loss)
    state.best_loss.copy_(torch.where(upd, pl, state.best_loss))
    state.best_k.copy_(torch.where(upd, s * chunk + j, state.best_k))
    state.reached.copy_(state.reached | (live & any_hit))
    state.run_best.copy_(torch.where(live, torch.maximum(state.run_best, run[..., -1]),
                                     state.run_best))
    state.done.copy_(state.reached.all(1))


def chunk_step_reference(points: torch.Tensor, cell_labels: torch.Tensor, hyp: torch.Tensor,
                         cell_order: torch.Tensor, bounds: torch.Tensor, state: ChunkState, *,
                         s: int, chunk: int, threshold: float, image_width: int,
                         patch_size: int, losses: torch.Tensor | None = None) -> None:
    """One chunk step, the plain twin of ``csrc/ransac.cu``: chunk s's
    outlier counts (``chunk_outliers_reference``) and the early-exit update
    (``_apply_chunk``) on `state`, for the frames not done; scored[b] += 1
    for each of them.

    points (B, H*W, 3) float32; cell_labels (B, gh, gw) plane ids (0 =
    none); hyp (B, MAXP, S*Kc, 4) the packed hypotheses (n0, n1, n2, d);
    cell_order (B, gh*gw) and bounds (B, MAXP+2): the cells sorted by plane
    id and each id's first position (``sample_hypotheses``), which the
    kernel walks and this twin, scoring from the cell labels, does not
    need. losses: an optional (B, MAXP, Kc) int32 tensor that receives the
    chunk's counts of each frame scored (a done frame's rows are left as
    they are). state.counts and state.tickets are the kernel's scratch: the
    twin leaves them 0."""
    live = ~state.done
    counts = chunk_outliers_reference(points, cell_labels, hyp[..., :3], hyp[..., 3],
                                      state.done, state.scored, s=s, chunk=chunk,
                                      threshold=threshold, image_width=image_width,
                                      patch_size=patch_size)
    if losses is not None:
        losses.copy_(torch.where(live[:, None, None], counts, losses))
    _apply_chunk(state, counts, live, s, chunk)


def _early_exit_winners(step, state: ChunkState, n_chunks: int, fixed_trip: bool):
    """The reference's early-exit rule over chunks of hypotheses: step(s,
    state) scores chunk s and updates `state` in place. With fixed_trip
    every chunk runs and nothing waits on the host; else the loop ends once
    every frame is done (one host check a chunk). Returns each plane's
    winning hypothesis index (B, MAXP) and the chunks scored per frame (B,)
    int32."""
    for s in range(n_chunks):
        if not fixed_trip and bool(state.done.all()):
            break
        step(s, state)
    return state.best_k, state.scored


def inlier_labels(pts: torch.Tensor, labels: torch.Tensor, best_n: torch.Tensor,
                   best_d: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """The final pass over (B, N) pixels: a labeled pixel keeps its label iff
    it is an inlier of its plane's winning model (best_n (B, MAXP, 3),
    best_d (B, MAXP))."""
    MAXP = best_d.shape[-1]
    labels = labels.to(torch.int64)
    lbl = torch.clamp(labels - 1, 0, MAXP - 1)
    n_pix = torch.gather(best_n, 1, lbl[..., None].expand(-1, -1, 3))
    err = pts[..., 0] * n_pix[..., 0]
    err += pts[..., 1] * n_pix[..., 1]
    err += pts[..., 2] * n_pix[..., 2]
    err += torch.gather(best_d, 1, lbl)
    keep = torch.abs(err) < thr
    return torch.where((labels > 0) & ~keep, torch.zeros_like(labels),
                       labels).to(torch.int32)


def chunk_plan(iterations: int, chunk_size: int | None) -> tuple[int, int]:
    """(Kc, S): hypotheses a chunk and chunks of the loop."""
    Kc = min(iterations, chunk_size or DEFAULT_CHUNK)
    return Kc, (iterations + Kc - 1) // Kc


def sample_pixels(cell_order: torch.Tensor, bounds: torch.Tensor, counts: torch.Tensor,
                  grid_width: int, image_width: int, patch_size: int, config: Config, *,
                  draws: torch.Tensor | None = None,
                  raw: torch.Tensor | None = None) -> torch.Tensor:
    """The (B, MAXP, K, 3) int64 pixels of every hypothesis's three points:
    ranks from `draws` (else ``draw_ranks``' from `raw`), the de-duplicating
    shift, then a plane's rank-th pixel through its cells in the order
    cell_order and bounds give (``sample_hypotheses``)."""
    B, G = cell_order.shape
    MAXP, K = config.max_planes, config.ransac_max_iterations
    P, W, gw, PP = patch_size, image_width, grid_width, patch_size * patch_size
    u = draws if draws is not None else draw_ranks(counts, K, raw=raw)
    idx = _distinct(u.to(counts.device, torch.int64).expand(B, MAXP, K, 3), counts)
    crank, t = idx // PP, idx % PP
    pos = torch.clamp(bounds[:, 1:-1, None, None] + crank, 0, G - 1)
    cell = torch.gather(cell_order, 1, pos.reshape(B, -1)).reshape(pos.shape)
    return ((cell // gw) * P + t // P) * W + ((cell % gw) * P + t % P)


def sample_hypotheses(pts: torch.Tensor, cell_labels: torch.Tensor, image_width: int,
                      patch_size: int, config: Config, *, draws: torch.Tensor | None = None,
                      raw: torch.Tensor | None = None, chunk_size: int | None = None):
    """Every plane's K hypotheses, sampled over the cell grid: (B, N, 3)
    float32 points and (B, gh, gw) cell labels -> (hyp (B, MAXP, S*Kc, 4)
    float32 packed (n0, n1, n2, d), sanitized and padded to S chunks of Kc;
    the planes' pixel counts (B, MAXP) int64; cell_order (B, gh*gw) int64,
    each frame's cells in a stable order of plane id; bounds (B, MAXP+2)
    int64, the first position of each id 0..MAXP+1 in that order; Kc, S).

    Stage 5 labels whole cells, so sampling a plane pixel is sampling a
    plane cell, then a pixel in it. draws and raw as ``refine_cells``."""
    dev = pts.device
    B = pts.shape[0]
    MAXP, K = config.max_planes, config.ransac_max_iterations
    gh, gw = cell_labels.shape[1:]
    PP, G = patch_size * patch_size, gh * gw
    cl = cell_labels.reshape(B, G).to(torch.int64)
    cell_order = torch.argsort(cl, dim=1, stable=True)
    marks = torch.arange(MAXP + 2, dtype=torch.int64, device=dev).expand(B, -1).contiguous()
    bounds = torch.searchsorted(torch.gather(cl, 1, cell_order), marks)
    counts = bounds.diff(dim=1)[:, 1:] * PP                  # (B, MAXP) pixels a plane
    pix = sample_pixels(cell_order, bounds, counts, gw, image_width, patch_size, config,
                        draws=draws, raw=raw)
    tri = torch.gather(pts, 1, pix.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(*pix.shape, 3)
    n_hyp, d_hyp = _fit_3pt_plane(tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
    Kc, S = chunk_plan(K, chunk_size)
    n_all, d_all = _sanitize(n_hyp, d_hyp, S * Kc)
    return torch.cat([n_all, d_all[..., None]], -1), counts, cell_order, bounds, Kc, S


class Sampling(NamedTuple):
    """Stage 6's sampling, what the early-exit loop starts from: the merged
    cell labels the chunk step reads, the hypotheses, the cells in plane
    order and the loop's first state."""
    cells: torch.Tensor        # (B, gh, gw) int32 merged cell labels
    hyp: torch.Tensor          # (B, MAXP, S*Kc, 4) float32 (n0, n1, n2, d)
    counts: torch.Tensor       # (B, MAXP) int64 pixels a plane
    cell_order: torch.Tensor   # (B, gh*gw) int64 cells in a stable order of plane id
    bounds: torch.Tensor       # (B, MAXP+2) int64 first position of each id 0..MAXP+1
    state: ChunkState          # before chunk 0
    chunk: int                 # Kc, hypotheses a chunk
    chunks: int                # S, chunks of the loop


def sample_stage_reference(points: torch.Tensor, labels_map: torch.Tensor,
                           merge_labels: torch.Tensor | None, image_width: int,
                           patch_size: int, config: Config, *,
                           draws: torch.Tensor | None = None, raw: torch.Tensor | None = None,
                           chunk_size: int | None = None) -> Sampling:
    """Stage 6's sampling, the plain twin of ``csrc/sampling.cu``: the
    merged cell labels (``ops.merge.apply_label_lut`` of round finalize's
    (B, gh, gw) labels_map and K3's (B, MAXP) merge_labels; merge_labels
    None: labels_map is merged already), ``sample_hypotheses`` on (B, N, 3)
    float32 points, and ``new_chunk_state`` at the config's inlier ratio.
    draws and raw as ``refine_cells``."""
    # ops.merge imports this module (inlier_labels), so its LUT comes late.
    from deplex_tpu_torch.ops.merge import apply_label_lut

    cells = labels_map if merge_labels is None else apply_label_lut(labels_map, merge_labels)
    hyp, counts, cell_order, bounds, Kc, S = sample_hypotheses(
        points, cells, image_width, patch_size, config, draws=draws, raw=raw,
        chunk_size=chunk_size)
    ratio = torch.full((), config.ransac_inliers_ratio, dtype=torch.float32,
                       device=points.device)
    return Sampling(cells.to(torch.int32).contiguous(), hyp, counts, cell_order, bounds,
                    new_chunk_state(counts.to(torch.float32), ratio, Kc), Kc, S)


def winners(hyp: torch.Tensor, best_k: torch.Tensor) -> torch.Tensor:
    """(B, MAXP, 4) each plane's winning model, hyp[b, m, best_k[b, m]]: what
    the final pass tests the pixels against (the labels kernel reads them
    from hyp itself; its twin is handed them)."""
    return torch.gather(hyp, 2, best_k[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]


def refine_cells(points: torch.Tensor, labels: torch.Tensor | None, cell_labels: torch.Tensor,
                 image_width: int, patch_size: int, config: Config, *,
                 merge_labels: torch.Tensor | None = None, step=None, sample=None,
                 draws: torch.Tensor | None = None, raw: torch.Tensor | None = None,
                 chunk_size: int | None = None, fixed_trip: bool | None = None, write=None):
    """Stage 6 for a batch: (B, N, 3) points, (B, N) labels and the (B, gh,
    gw) final cell labels -> ((B, N) int32 labels, (B,) int32 chunks scored
    per frame).

    merge_labels: K3's (B, MAXP) merge labels, with cell_labels round
    finalize's labels_map (the sampler merges them); None when cell_labels
    are merged already. sample: the sampler with
    ``sample_stage_reference``'s signature (that twin by default; the
    pipeline passes the kernel of ``csrc/sampling.cu``). step: the chunk
    step with ``chunk_step_reference``'s signature (that twin by default).
    draws (MAXP, K, 3) or (B, MAXP, K, 3) int: raw ranks in [0, cnt_p) that
    replace ``draw_ranks``' (cnt_p = the pixel count of plane p+1); raw: the
    (MAXP, K, 3) numbers ``draw_ranks`` takes (``default_draws`` when
    None). fixed_trip: run every chunk with the early exit on the device
    (the default on a card) rather than stop on a host check (the CPU's).
    write: the final pass, ``write(points (B, N, 3), hyp (B, MAXP, S*Kc, 4),
    best_k (B, MAXP) int64 each plane's winner in hyp, threshold)`` -> the
    labels it returns (the pipeline's writes them from the cell labels in
    the labels kernel, which reads the winners itself; `labels` is then
    unused); by default ``inlier_labels`` over `labels` with the winners
    gathered."""
    dev = points.device
    B = cell_labels.shape[0]
    W, P = image_width, patch_size
    pts = points.to(torch.float32).reshape(B, -1, 3).contiguous()
    sampled = (sample or sample_stage_reference)(
        pts, cell_labels, merge_labels, W, P, config, draws=draws, raw=raw,
        chunk_size=chunk_size)
    step = step or chunk_step_reference
    thr = float(config.ransac_threshold)

    def chunk(s, state):
        step(pts, sampled.cells, sampled.hyp, sampled.cell_order, sampled.bounds, state, s=s,
             chunk=sampled.chunk, threshold=thr, image_width=W, patch_size=P)

    best_k, scored = _early_exit_winners(chunk, sampled.state, sampled.chunks,
                                         dev.type != "cpu" if fixed_trip is None else fixed_trip)
    if write is not None:
        return write(pts, sampled.hyp, best_k, thr), scored
    best = winners(sampled.hyp, best_k)
    thr_t = torch.full((), thr, dtype=torch.float32, device=dev)
    return inlier_labels(pts, labels, best[..., :3], best[..., 3], thr_t), scored


def _refine_pixels(points: torch.Tensor, labels: torch.Tensor, config: Config,
                   draws: torch.Tensor | None, chunk_size: int | None) -> torch.Tensor:
    """Stage 6 of one frame with arbitrary pixel labels (no cell grid): the
    planes' pixels are grouped by a stable argsort of all N labels. Plain
    ops, stopping on a host check; no entry point takes this path."""
    dev = points.device
    N = points.shape[0]
    MAXP, K = config.max_planes, config.ransac_max_iterations
    pts = points.to(torch.float32)
    plane_ids = torch.arange(1, MAXP + 1, device=dev)
    labels = labels.to(torch.int64)
    order, pcounts, offsets = _group_bounds(labels, MAXP)
    counts = pcounts[plane_ids]
    u = draws if draws is not None else draw_ranks(counts, K)
    idx = _distinct(u.to(dev, torch.int64), counts)
    tri = pts[order[torch.clamp(offsets[plane_ids][:, None, None] + idx, 0, N - 1)]]
    n_hyp, d_hyp = _fit_3pt_plane(tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
    Kc, S = chunk_plan(K, chunk_size)
    n_all, d_all = _sanitize(n_hyp, d_hyp, S * Kc)
    thr = torch.full((), config.ransac_threshold, dtype=torch.float32, device=dev)
    group = torch.where((labels >= 1) & (labels <= MAXP), labels, torch.zeros_like(labels))
    n_pts = torch.zeros(MAXP + 1, dtype=torch.float32, device=dev).scatter_add_(
        0, group, torch.ones(N, dtype=torch.float32, device=dev))[1:]
    x, y, z = (pts[:, i:i + 1] for i in range(3))

    def step(s, state):
        nck, dck = n_all[:, s * Kc:(s + 1) * Kc], d_all[:, s * Kc:(s + 1) * Kc]
        n_tab = torch.cat([torch.zeros_like(nck[:1]), nck])
        d_tab = torch.cat([torch.zeros_like(dck[:1]), dck])
        out = _outliers(x, y, z, n_tab[group], d_tab[group], thr)
        acc = torch.zeros((MAXP + 1, Kc), dtype=torch.int64, device=dev)
        chunk_counts = acc.index_add_(0, group, out.to(torch.int64))[1:][None]
        live = ~state.done
        state.scored.add_(live.to(torch.int32))
        _apply_chunk(state, chunk_counts, live, s, Kc)

    ratio = torch.full((), config.ransac_inliers_ratio, dtype=torch.float32, device=dev)
    best_k, _ = _early_exit_winners(step, new_chunk_state(n_pts[None], ratio, Kc), S,
                                    fixed_trip=False)
    rows = torch.arange(MAXP, device=dev)
    best_n, best_d = n_all[rows, best_k[0]], d_all[rows, best_k[0]]
    return inlier_labels(pts[None], labels[None], best_n[None], best_d[None], thr)[0]


def refine_labels(points: torch.Tensor, labels: torch.Tensor, config: Config, *,
                  draws: torch.Tensor | None = None,
                  cell_labels: torch.Tensor | None = None,
                  image_width: int | None = None,
                  patch_size: int | None = None,
                  chunk_size: int | None = None) -> torch.Tensor:
    """points (N, 3), labels (N,) int -> refined (N,) int32 labels.

    cell_labels (gh, gw) with image_width and patch_size: the final per-cell
    plane ids; stage 6 then runs as ``refine_cells`` on a batch of one.
    Without it (arbitrary pixel labels) the planes' pixels are grouped by a
    stable argsort of all N labels.

    draws (MAXP, K, 3) int: raw ranks in [0, cnt_p) that replace the
    default stream of `draw_ranks` (cnt_p = the pixel count of plane p+1)."""
    if cell_labels is None:
        return _refine_pixels(points, labels, config, draws, chunk_size)
    return refine_cells(points[None], labels[None], cell_labels[None], image_width,
                        patch_size, config, draws=draws, chunk_size=chunk_size)[0][0]


def refine_batch(points: torch.Tensor, labels: torch.Tensor, cell_labels: torch.Tensor,
                 image_width: int, patch_size: int, config: Config) -> torch.Tensor:
    """Stage 6 for a batch with the plain scorer and the default draws:
    (B, N, 3) points, (B, N) labels, (B, gh, gw) cell labels -> (B, N)
    int32 (``refine_cells``' labels)."""
    return refine_cells(points, labels, cell_labels, image_width, patch_size, config)[0]
