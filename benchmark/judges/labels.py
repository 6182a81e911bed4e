"""The plane-label judge: the labels the window's own calls produced, a
seeded sample of them, against the plain reference's labels of the same
input frames, computed after the window on the same device.

The port's card kernels are bit-equal to the plain stages they were ported
from, so the comparison is exact: every judged pixel's label must equal the
reference's (``mismatched_px`` at most 0), and at least one frame must have
been judged; ``failed`` counts the frames whose labels differ anywhere. The
reference runs once a distinct input batch, in float32 with TF32 off
(``benchmark.reference``), and takes nothing from the program. The control
puts the reference in TF32 in the place of the two entries the label
drivers call (``extract_depth_batch_jit``, ``PlaneExtractor.process_depth``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark import costs
from benchmark.judge import Verdict
from benchmark.reference import precision, stages


def judge(samples: list, cell, device: torch.device, records: bool = False) -> Verdict:
    """samples: (key, (B, H, W) uint16 input frames, (B, H*W) labels the
    program returned for them) of each judged call; a key names one
    distinct input batch. With `records`, also the stages' least seconds a
    call, from the reference's intermediates of each distinct batch."""
    config = cell.reference_config()
    K = torch.as_tensor(cell.intrinsics, device=device)
    refs, least = {}, []
    mismatched = frames = failed = 0
    for key, depth, labels in samples:
        labels = labels.to(device)
        if key not in refs:
            rec = stages.Record() if records else None
            refs[key] = stages.labels(depth.to(device), K, config, labels.dtype, rec)
            if rec is not None:
                least.append(sum(costs.call_least_s(rec, config, labels.dtype).values()))
        ref = refs[key]
        if labels.shape != ref.shape:
            diff = torch.ones(ref.shape, dtype=torch.bool, device=device)
        else:
            diff = labels != ref
        mismatched += int(diff.sum())
        failed += int(diff.reshape(diff.shape[0], -1).any(1).sum())
        frames += ref.shape[0]
    compared = {"frames_judged": {"value": frames, "limit": 1, "rule": "at least"},
                "mismatched_px": {"value": mismatched, "limit": 0, "rule": "at most"}}
    correct = frames >= 1 and mismatched <= 0
    return Verdict(correct, failed, compared, sum(least) / len(least) if least else None)


def _tf32_labels(cell, depth: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    K = torch.as_tensor(cell.intrinsics, device=device)
    with precision.tf32():
        return stages.labels(depth.to(device), K, cell.reference_config(), dtype)


def _depth(d, device) -> torch.Tensor:
    if isinstance(d, torch.Tensor):
        return d.to(device)
    arr = np.ascontiguousarray(d)
    return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.uint16)


@contextlib.contextmanager
def in_place_of_program(cell, device):
    """The program's entry of the cell's driver replaced by the reference in
    TF32, with the entry's signature and output."""
    from deplex_tpu_torch import PlaneExtractor
    from deplex_tpu_torch.parallel import batch

    def depth_batch(depth, intrinsics, *, config):
        return _tf32_labels(cell, depth, torch.uint8, depth.device)

    def process_depth(self, depth, intrinsics):
        return _tf32_labels(cell, _depth(depth, device)[None], torch.int32, device)[0].cpu().numpy()

    saved = (batch.extract_depth_batch_jit, PlaneExtractor.process_depth)
    batch.extract_depth_batch_jit = depth_batch
    PlaneExtractor.process_depth = process_depth
    try:
        yield
    finally:
        batch.extract_depth_batch_jit, PlaneExtractor.process_depth = saved
