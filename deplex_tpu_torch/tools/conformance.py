"""Golden conformance of the shipped configs: F1, plane counts, card vs CPU.

Port of the reference package's ``scripts/tpu_conformance.py``. For each
config it extracts the frame's planes with ``PlaneExtractor.process_depth``
on the device and reports

  * plane-label F1 against the C++ reference's golden labels
    (``data/golden/*.npz``), bound >= 0.95 (BASELINE.json);
  * the planes found (the largest label): exactly 34 on TUM at the default
    config, as the reference finds;
  * on a card, ``card_vs_cpu_equal``: the card's labels equal the plain
    twins' on the CPU, and K1's 13 moment planes are bit-equal (the
    reference held its two stage-1 paths to each other the same way).

The configs: TUM fr3 at the default config, ICL-NUIM with its ini (P=4)
and ICL-NUIM at the default config (BASELINE.json config 1). It prints one
JSON line, writes JSON only to ``--out``, and exits 1 when a check fails.

    python -m deplex_tpu_torch.tools.conformance [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from deplex_tpu_torch.config import Config
from deplex_tpu_torch.tools._common import DATA, card_info, device_arg, label_f1, write_report

# name: (depth PNG, intrinsics, ini or None for the default config, golden)
CONFIGS = {
    "tum_default": ("tum/1341848230.910894.png", "TUM_fr3_long_val.K", None,
                    "tum_default_labels"),
    "icl_ini": ("icl_nuim/0.png", "ICL_living_room.K", "ICL_living_room.ini",
                "icl_ini_labels"),
    "icl_default": ("icl_nuim/0.png", "ICL_living_room.K", None, "icl_default_labels"),
}
F1_BOUND = 0.95
PLANES = {"tum_default": 34}     # the reference's exact count


def load_case(name: str):
    """(uint16 depth, K, Config, golden labels) of a config."""
    from deplex_tpu_torch.utils import DepthImage, read_intrinsics

    png, kfile, ini, golden = CONFIGS[name]
    depth = DepthImage(str(DATA / png)).data
    K = read_intrinsics(str(DATA / "configs" / kfile))
    cfg = Config.from_ini(str(DATA / "configs" / ini)) if ini else Config()
    return depth, K, cfg, np.load(DATA / "golden" / f"{golden}.npz")["labels"]


def extract(depth, K, cfg: Config, device) -> np.ndarray:
    from deplex_tpu_torch import PlaneExtractor

    return PlaneExtractor(depth.shape[0], depth.shape[1], cfg, device=device).process_depth(
        depth, K)


def card_vs_cpu(depth, K, cfg: Config, labels: np.ndarray, dev: torch.device) -> dict:
    """The card's labels and K1's moment planes against the CPU twins'."""
    from deplex_tpu_torch.kernels.cellstats import cell_moments
    from deplex_tpu_torch.ops.cellstats import finalize_cell_stats, patch_size
    from deplex_tpu_torch.pipeline import depth_tensor

    cpu = extract(depth, K, cfg, "cpu")
    Kt = torch.as_tensor(K)
    m_card = cell_moments(depth_tensor(depth[None], dev), Kt, cfg)
    m_cpu = cell_moments(depth_tensor(depth[None], "cpu"), Kt, cfg)
    P = patch_size(depth.shape[0], depth.shape[1], cfg)
    s_card, s_cpu = finalize_cell_stats(m_card, P, cfg), finalize_cell_stats(m_cpu, P, cfg)
    moments_equal = all(torch.equal(a.cpu(), b) for a, b in zip(m_card, m_cpu))
    return {"pixels_differing": int((labels != cpu).sum()),
            "cell_moments_bit_equal": moments_equal,
            "cell_stats_bit_equal": all(torch.equal(a.cpu(), b)
                                        for a, b in zip(s_card, s_cpu)),
            "card_vs_cpu_equal": bool(np.array_equal(labels, cpu)) and moments_equal}


def check(name: str, device=None) -> dict:
    """One config's entry: f1, planes, card_vs_cpu_equal (None on the CPU),
    and ``pass``."""
    from deplex_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    depth, K, cfg, gold = load_case(name)
    labels = extract(depth, K, cfg, dev)
    entry = {"f1": round(label_f1(labels, gold), 4), "planes": int(labels.max()),
             "card_vs_cpu_equal": None}
    ok = entry["f1"] >= F1_BOUND and entry["planes"] == PLANES.get(name, entry["planes"])
    if dev.type == "cuda":
        entry.update(card_vs_cpu(depth, K, cfg, labels, dev))
        ok = ok and entry["card_vs_cpu_equal"]
    entry["pass"] = bool(ok)
    return entry


def run(device=None, configs=tuple(CONFIGS)) -> dict:
    report = {**card_info(device), "f1_bound": F1_BOUND, "configs": {}}
    for name in configs:
        report["configs"][name] = check(name, device)
    report["pass"] = all(e["pass"] for e in report["configs"].values())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help=f"comma-separated, of {sorted(CONFIGS)}")
    ap.add_argument("--out", default=None, help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    report = run(args.device, [c for c in args.configs.split(",") if c])
    print(json.dumps(report))
    if args.out:
        write_report(args.out, report)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
