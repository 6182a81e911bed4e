"""Stage 3 — region growing as directed reachability, then per-round fits.

Port of ``deplex_tpu.ops.growing``. A seed's region is the set of cells
reachable from it over the "admissibility" edges
    b -> c  iff  n_b . n_c >= min_cos  and  (n_b . mu_c + d_b)^2 <= tol_c
inside the unassigned planar cells, so the order in which a fill visits
cells does not change the region.

  1. The rounds loop — pick the dominant histogram bin, seed at its min-MSE
     cell, fill, consume — is the hand kernel ``csrc/growing.cu`` on the
     card; ``grow_rounds`` below is its plain twin. Both output a per-cell
     ``round_map``, each round's seed and the round count.
  2. ``region_sums`` recovers each round's moment sums from the round map.
  3. ``finalize_rounds`` fits every round's plane, applies the size and
     planarity gates and assigns plane slots in accept order.

All tensors carry a leading frame axis B.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.ops.cellstats import CellStats
from deplex_tpu_torch.ops.eigh3x3 import eigh3x3_min
from deplex_tpu_torch.ops.histogram import normal_bins


class PlaneSegments(NamedTuple):
    """Fixed-capacity (max_planes) plane slots per frame; slot 0 = plane 1."""

    nr_planes: torch.Tensor   # (B,) int32 occupied slots
    n: torch.Tensor           # (B, MAXP) point counts
    coord_sum: torch.Tensor   # (B, MAXP, 3)
    scatter: torch.Tensor     # (B, MAXP, 3, 3) centered second moments
    normal: torch.Tensor      # (B, MAXP, 3)
    mean: torch.Tensor        # (B, MAXP, 3)
    d: torch.Tensor           # (B, MAXP)
    mse: torch.Tensor         # (B, MAXP)
    score: torch.Tensor       # (B, MAXP)


class RoundData(NamedTuple):
    """Output of the rounds loop plus its per-round sums."""

    round_map: torch.Tensor   # (B, gh, gw) int32 round that consumed the cell, -1
    sums: torch.Tensor        # (B, R_MAX, 16) float32 packed per-round statistics
    nr_rounds: torch.Tensor   # (B,) int32


# sums row layout: [n_pts, sum_x, sum_y, sum_z,
#                   sc_xx, sc_xy, sc_xz, sc_yy, sc_yz, sc_zz, size_cells, 0...]
_N, _SX, _XX, _SIZE = 0, 1, 4, 10

# Edge directions, in the bit order of the packed edge byte the growing
# kernel reads; bit 4 of that byte is the planar flag.
EDGE_NAMES = ("from_up", "from_down", "from_left", "from_right")


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def fit_plane(scatter, coord_sum, n):
    """Plane fit of (batched) stats: (normal, mean, d, mse, score)."""
    w, v = eigh3x3_min(scatter)
    mean = coord_sum / n[..., None]
    d_raw = -_dot3(mean, v)
    normal = torch.where((d_raw > 0)[..., None], v, -v)
    d = torch.abs(d_raw)
    mse = w[..., 0] / n
    wsum = w[..., 0] + w[..., 1] + w[..., 2]
    score = torch.where(wsum != 0, w[..., 2] / wsum, torch.zeros_like(wsum))
    return normal, mean, d, mse, score


def admissibility_edges(stats: CellStats, config: Config) -> dict:
    """Directed edge masks for the four in-neighbour directions.

    mask[b, r, c] is True iff the named neighbour of (r, c) may activate
    (r, c); e.g. 'from_up' is the neighbour (r-1, c). Border entries are
    False. Shapes (B, gh, gw).
    """
    n_c, mu_c, tol_c = stats.normal, stats.mean, stats.tol
    min_cos = config.min_cos_angle_merge
    gh, gw = tol_c.shape[-2:]
    row = torch.arange(gh, device=tol_c.device)[:, None]
    col = torch.arange(gw, device=tol_c.device)[None, :]

    edges = {}
    for name, (dr, dc) in zip(EDGE_NAMES, ((1, 0), (-1, 0), (0, 1), (0, -1))):
        nb_normal = torch.roll(n_c, (dr, dc), dims=(1, 2))
        nb_d = torch.roll(stats.d, (dr, dc), dims=(1, 2))
        ok = (_dot3(nb_normal, n_c) >= min_cos) & \
             ((_dot3(nb_normal, mu_c) + nb_d) ** 2 <= tol_c)
        if dr == 1:
            ok = ok & (row >= 1)
        elif dr == -1:
            ok = ok & (row < gh - 1)
        if dc == 1:
            ok = ok & (col >= 1)
        elif dc == -1:
            ok = ok & (col < gw - 1)
        edges[name] = ok
    return edges


def pack_edges(edges: dict, planar: torch.Tensor) -> torch.Tensor:
    """(B, gh, gw) uint8: bit k = edges[EDGE_NAMES[k]], bit 4 = planar."""
    packed = planar.to(torch.uint8) << 4
    for k, name in enumerate(EDGE_NAMES):
        packed = packed | (edges[name].to(torch.uint8) << k)
    return packed


def flood_fill(seed_mask: torch.Tensor, allowed: torch.Tensor, edges: dict,
               hops_per_step: int = 8) -> torch.Tensor:
    """Directed reachability from seed_mask within `allowed` (B, gh, gw)."""
    active = seed_mask
    while True:
        before = int(active.sum())
        for _ in range(hops_per_step):
            grown = ((torch.roll(active, 1, dims=1) & edges["from_up"])
                     | (torch.roll(active, -1, dims=1) & edges["from_down"])
                     | (torch.roll(active, 1, dims=2) & edges["from_left"])
                     | (torch.roll(active, -1, dims=2) & edges["from_right"]))
            active = active | (allowed & grown)
        if int(active.sum()) == before:
            return active


def grow_rounds_loop(bins: torch.Tensor, mse: torch.Tensor, edges: dict,
                     planar: torch.Tensor, config: Config):
    """Plain twin of the growing kernel: the rounds loop of every frame.

    bins (B, gh, gw) int32 (-1 = not planar), mse (B, gh, gw), edges as from
    ``admissibility_edges``, planar (B, gh, gw) bool. Returns round_map
    (B, gh, gw) int32, seeds (B, R_MAX) int32 (flat id of each round's seed,
    gh*gw where no round ran) and nr_rounds (B,) int32; nr_rounds counts the
    final round that stopped. Frames run in lock step; each stops on its own.
    """
    B, gh, gw = planar.shape
    N = gh * gw
    dev = planar.device
    R_MAX = config.max_region_growing_rounds
    nb2 = config.histogram_bins_per_coord ** 2
    frames = torch.arange(B, device=dev)
    cell_flat = torch.arange(N, device=dev)

    live_bins = torch.where(planar, bins, torch.full_like(bins, -1)).reshape(B, N)
    unassigned = planar.clone()
    round_map = torch.full((B, gh, gw), -1, dtype=torch.int32, device=dev)
    seeds = torch.full((B, R_MAX), N, dtype=torch.int32, device=dev)
    remaining = planar.reshape(B, N).sum(1)
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    active = remaining > 0
    mse_flat = mse.reshape(B, N)

    while bool(active.any()):
        # 1. Dominant bin of each frame's live cells (first max wins).
        in_range = (live_bins >= 0) & (live_bins < nb2)
        keys = torch.where(in_range, live_bins + frames[:, None] * nb2,
                           torch.full_like(live_bins, B * nb2))
        hist = torch.bincount(keys.reshape(-1).to(torch.int64),
                              minlength=B * nb2 + 1)[:B * nb2].reshape(B, nb2)
        mf_bin = torch.argmax(hist, dim=1)
        stop = hist[frames, mf_bin] < config.min_region_growing_candidate_size

        # 2. Seed: min-MSE candidate (first min wins; index 0 if none).
        candidates = live_bins == mf_bin[:, None]
        seed_mse = torch.where(candidates, mse_flat, torch.full_like(mse_flat, float("inf")))
        seed_id = torch.argmin(seed_mse, dim=1)
        grow = active & ~stop
        seed_mask = ((cell_flat[None, :] == seed_id[:, None]) & grow[:, None]).reshape(B, gh, gw)

        # 3. Grow inside the unassigned cells.
        region = flood_fill(seed_mask & unassigned, unassigned, edges)

        # 4. Consume; record the seed of every round that ran, stopped or not.
        rflat = region.reshape(B, N)
        live_bins = torch.where(rflat, torch.full_like(live_bins, -1), live_bins)
        unassigned = unassigned & ~region
        remaining = remaining - rflat.sum(1)
        round_map = torch.where(region, rounds[:, None, None].to(torch.int32), round_map)
        ran = frames[active]
        seeds[ran, rounds[active]] = seed_id[active].to(torch.int32)
        rounds = rounds + active.to(torch.int64)
        active = active & ~stop & (remaining > 0) & (rounds < R_MAX)

    return round_map, seeds, rounds.to(torch.int32)


def region_sums(round_map: torch.Tensor, seeds: torch.Tensor, stats: CellStats,
                r_max: int) -> torch.Tensor:
    """Per-round sufficient statistics recovered from the consumption map.

    round_map (B, gh, gw), seeds (B, r_max) flat seed ids (out-of-range where
    no round ran). The seed cell is weighted twice, as the reference seeds
    its accumulator with a copy of the seed. Per-cell second moments are
    recentred about their round's mean before the weighted reduction.
    Reductions are one-hot matrix products: deterministic on the card, where
    float atomics would let the summation order decide the planarity gate.
    Returns (B, r_max, 16) float32 rows in the RoundData.sums layout.
    """
    B, gh, gw = round_map.shape
    N = gh * gw
    dev = round_map.device
    f32 = torch.float32
    rm = round_map.reshape(B, N)
    rids = torch.arange(r_max, dtype=torch.int32, device=dev)
    onehot = rm[:, None, :] == rids[None, :, None]                  # (B, R, N)
    is_seed = seeds[:, :, None] == torch.arange(N, dtype=seeds.dtype, device=dev)
    w = onehot.to(f32) * (1.0 + is_seed.to(f32))
    size = onehot.sum(2).to(f32)

    nr_pts = stats.nr_pts.to(f32)
    cs = stats.coord_sum.reshape(B, N, 3).to(f32)
    mean = stats.mean.reshape(B, N, 3).to(f32)

    n_tot = w.sum(2) * nr_pts                                       # (B, R)
    sum_tot = torch.bmm(w, cs)                                      # (B, R, 3)
    mu = sum_tot / torch.clamp(n_tot, min=1.0)[..., None]
    # Each consumed cell's round mean (0 for unconsumed cells, weight 0).
    mu_cell = torch.gather(mu, 1, rm.clamp(min=0).to(torch.int64)[..., None].expand(B, N, 3))
    mu_cell = mu_cell * (rm >= 0)[..., None].to(f32)
    dmu = mean - mu_cell
    sc = stats.scatter.reshape(B, N, 3, 3).to(f32)
    feat = torch.stack([
        sc[..., 0, 0] + nr_pts * dmu[..., 0] * dmu[..., 0],
        sc[..., 0, 1] + nr_pts * dmu[..., 0] * dmu[..., 1],
        sc[..., 0, 2] + nr_pts * dmu[..., 0] * dmu[..., 2],
        sc[..., 1, 1] + nr_pts * dmu[..., 1] * dmu[..., 1],
        sc[..., 1, 2] + nr_pts * dmu[..., 1] * dmu[..., 2],
        sc[..., 2, 2] + nr_pts * dmu[..., 2] * dmu[..., 2],
    ], dim=-1)                                                      # (B, N, 6)
    sc_tot = torch.bmm(w, feat)                                     # (B, R, 6)

    return torch.cat([n_tot[..., None], sum_tot, sc_tot, size[..., None],
                      torch.zeros((B, r_max, 5), dtype=f32, device=dev)], dim=-1)


def grow_rounds(stats: CellStats, config: Config) -> RoundData:
    """Plain twin of the growing stage: bins, edges, the rounds loop in
    plain PyTorch, then ``region_sums``."""
    bins = normal_bins(stats.normal, stats.planar, config.histogram_bins_per_coord)
    edges = admissibility_edges(stats, config)
    round_map, seeds, nr_rounds = grow_rounds_loop(bins, stats.mse, edges,
                                                   stats.planar, config)
    sums = region_sums(round_map, seeds, stats, config.max_region_growing_rounds)
    return RoundData(round_map=round_map, sums=sums, nr_rounds=nr_rounds)


def finalize_rounds(rounds: RoundData, config: Config):
    """Order-independent post-pass: batched fits, gates, slots, labels.

    Returns (labels_map (B, gh, gw) int32, PlaneSegments); labels_map value
    k > 0 means plane slot k-1.
    """
    sums = rounds.sums
    B, R_MAX = sums.shape[:2]
    MAXP = config.max_planes
    dev = sums.device
    n = torch.clamp(sums[..., _N], min=1.0)
    coord_sum = sums[..., _SX:_SX + 3]
    sc = sums[..., _XX:_XX + 6]
    scatter = torch.stack([
        torch.stack([sc[..., 0], sc[..., 1], sc[..., 2]], -1),
        torch.stack([sc[..., 1], sc[..., 3], sc[..., 4]], -1),
        torch.stack([sc[..., 2], sc[..., 4], sc[..., 5]], -1),
    ], -2)                                                          # (B, R, 3, 3)
    size = sums[..., _SIZE]

    normal, mean, d, mse, score = fit_plane(scatter, coord_sum, n)

    live = torch.arange(R_MAX, device=dev)[None, :] < rounds.nr_rounds[:, None]
    accept = (live & (size >= config.min_region_growing_cells_activated)
              & (score > config.min_region_planarity_score))
    slot = torch.cumsum(accept.to(torch.int32), dim=1) - 1          # accept order
    accept = accept & (slot < MAXP)
    nr_planes = accept.sum(1).to(torch.int32)

    # Per-cell labels: round -> slot + 1 (0 for rejected or unconsumed).
    label_of_round = torch.where(accept, slot + 1, torch.zeros_like(slot))
    lut = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                     label_of_round.to(torch.int32)], dim=1)        # (B, R+1)
    rm = rounds.round_map.reshape(B, -1).to(torch.int64) + 1
    labels_map = torch.gather(lut, 1, rm).reshape(rounds.round_map.shape)

    # Slot table: the round that filled each slot (each slot has at most one).
    round_of_slot = torch.full((B, MAXP + 1), R_MAX, dtype=torch.int64, device=dev)
    target = torch.where(accept, slot.to(torch.int64), torch.full_like(slot, MAXP).to(torch.int64))
    round_of_slot.scatter_(1, target, torch.arange(R_MAX, device=dev).expand(B, R_MAX).contiguous())
    round_of_slot = round_of_slot[:, :MAXP]
    filled = torch.arange(MAXP, device=dev)[None, :] < nr_planes[:, None]
    idx = torch.where(filled, round_of_slot, torch.zeros_like(round_of_slot))

    def table(x):
        """(B, R, ...) per-round values -> (B, MAXP, ...) slot values."""
        tail = (1,) * (x.dim() - 2)
        g = torch.gather(x, 1, idx.reshape(B, MAXP, *tail).expand(B, MAXP, *x.shape[2:]))
        return torch.where(filled.reshape(B, MAXP, *tail), g, torch.zeros_like(g))

    segments = PlaneSegments(nr_planes=nr_planes, n=table(sums[..., _N]),
                             coord_sum=table(coord_sum), scatter=table(scatter),
                             normal=table(normal), mean=table(mean), d=table(d),
                             mse=table(mse), score=table(score))
    return labels_map, segments
