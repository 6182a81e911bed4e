"""Per-plane conformance decomposition against the C++ reference golden.

Port of the reference package's ``scripts/conformance_decomposition.py``:
is the TUM residual against the golden a systematic gate bias, or float32
tie-break noise in seed selection and merge order? On the TUM frame at the
default config:

  1. per golden plane, the IoU with its greedily matched predicted plane
     (the matching of the F1 metric);
  2. the extraction again under ``--perturbations`` sub-quantization depth
     jitters, depth + U(-0.5, 0.5) raw units (seed 0), invalid pixels kept
     invalid: below the sensor's resolution, so a faithful pipeline may
     give any of these answers;
  3. every pixel that disagrees with the golden in the unperturbed run is
     "stable" if it disagrees in every run (a candidate bias) and
     "unstable" if its agreement flips under some jitter (noise), and the
     disagreement is broken down by kind.

It runs on the device (the card by default), prints the report without its
per-plane rows, and writes the whole report only to ``--out``.

    python -m deplex_tpu_torch.tools.conformance_decomposition [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.tools._common import (DATA, TUM_K, TUM_PNG, card_info, device_arg,
                                            match_planes, write_report)


def canon(labels: np.ndarray, gold: np.ndarray) -> np.ndarray:
    """Predicted ids remapped onto their matched golden ids (label numbers
    are assignment order: only the partition compares); an unmatched
    predicted plane gets an id of its own past the golden's."""
    inv = {p: g for g, p in match_planes(labels, gold).items() if p is not None}
    lut = np.zeros(int(labels.max()) + 1, labels.dtype)
    nxt = int(gold.max()) + 1
    for pid in np.unique(labels[labels > 0]):
        if int(pid) in inv:
            lut[pid] = inv[int(pid)]
        else:
            lut[pid] = nxt
            nxt += 1
    return lut[labels]


def plane_ious(labels: np.ndarray, gold: np.ndarray) -> list:
    rows = []
    for g, p in sorted(match_planes(labels, gold).items()):
        gm = gold == g
        if p is None:
            rows.append({"gold_id": g, "pred_id": None, "gold_px": int(gm.sum()), "iou": 0.0})
            continue
        pm = labels == p
        rows.append({"gold_id": g, "pred_id": p, "gold_px": int(gm.sum()),
                     "iou": round(int((gm & pm).sum()) / max(int((gm | pm).sum()), 1), 4)})
    return rows


def run(device=None, perturbations: int = 5, seed: int = 0) -> dict:
    from deplex_tpu_torch.pipeline import backproject_device, extract_planes, resolve_device
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    dev = resolve_device(device)
    img = DepthImage(str(TUM_PNG))
    K = torch.as_tensor(read_intrinsics(str(TUM_K)))
    H, W = img.height, img.width
    depth = np.asarray(img.data, np.float32)
    gold = np.load(DATA / "golden" / "tum_default_labels.npz")["labels"]
    cfg = Config()

    def extract(d: np.ndarray) -> np.ndarray:
        pts = backproject_device(torch.from_numpy(d).to(dev), K)
        return extract_planes(pts, image_height=H, image_width=W, config=cfg).cpu().numpy()

    base = extract(depth)
    cb = canon(base, gold)
    disagree = cb != gold
    always = disagree.copy()
    rng = np.random.default_rng(seed)
    for _ in range(perturbations):
        jittered = depth + rng.uniform(-0.5, 0.5, depth.shape).astype(np.float32)
        jittered = np.where(depth > 0, jittered, 0.0).astype(np.float32)
        always &= canon(extract(jittered), gold) != gold

    n_dis, n_stable, total = int(disagree.sum()), int(always.sum()), int(gold.size)
    frac = round(n_stable / max(n_dis, 1), 4)
    report = {
        **card_info(dev),
        "frame": "tum/1341848230.910894.png", "config": "default",
        "golden": "data/golden/tum_default_labels.npz (C++ reference build)",
        "perturbations": perturbations,
        "perturbation_model": "depth + U(-0.5, 0.5) raw units (sub-sensor-quantization; "
                              "invalid pixels kept invalid)",
        "total_px": total,
        "disagree_px": n_dis,
        "disagree_frac": round(n_dis / total, 5),
        "stable_disagree_px": n_stable,
        "stable_frac_of_disagreement": frac,
        "disagreement_breakdown_px": {
            "gold_planar_pred_zero": int((disagree & (gold > 0) & (cb == 0)).sum()),
            "gold_zero_pred_planar": int((disagree & (gold == 0) & (cb > 0)).sum()),
            "different_plane": int((disagree & (gold > 0) & (cb > 0)).sum()),
        },
        "planes": plane_ious(base, gold),
    }
    if frac >= 0.5:
        report["conclusion"] = (
            f"Not input-noise tie-breaking: {100 * frac:.0f}% of the {n_dis} disagreeing "
            f"pixels ({100 * n_dis / total:.2f}% of the frame) persist under "
            "sub-quantization depth jitter: a deterministic assignment difference at "
            "whole-cell granularity (the round-based growing and merge order against the "
            "reference's sequential histogram consumption), not a gate bias over an "
            "extended region.")
    else:
        report["conclusion"] = (
            f"{100 * (1 - frac):.1f}% of the disagreement flips under sub-quantization "
            f"depth jitter (tie-break noise); the stable remainder is {n_stable} pixels, "
            f"{100 * n_stable / total:.2f}% of the frame.")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--perturbations", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the whole report here (JSON)")
    args = ap.parse_args(argv)
    report = run(args.device, args.perturbations, args.seed)
    print(json.dumps({k: v for k, v in report.items() if k != "planes"}))
    if args.out:
        write_report(args.out, report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
