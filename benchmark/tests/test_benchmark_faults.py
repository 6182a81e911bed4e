"""A run's ``correct`` on the CPU at a tiny size, the card's look skipped and
the rest of the run driven as on the card: true for the program as it is,
false for the control (the reference in TF32 in the program's place) and
for the program broken underneath: a label altered where the labels kernel
writes it, half of a batch left out, RANSAC's chunk step returning its
state unchanged."""

import contextlib

import pytest
import torch

from benchmark import control, harness

CPU = torch.device("cpu")
SMALL = {
    "tum_default.resident_b64": {"batch": 2, "ring_batches": 2, "sample_calls": 2},
    "tum_default.camera_b1": {"ring_frames": 3, "sample_calls": 2},
    "tum_ransac.resident_b8": {"batch": 1, "ring_batches": 1, "sample_calls": 1},
}


@pytest.fixture(scope="module")
def root():
    return harness.ROOT


def _cell(root, workload):
    cell = harness.resolve(workload, root=root)
    cell.traffic.update(SMALL[workload])
    return cell


def _run(root, workload, seed=2 ** 31 + 3):
    return harness.run(_cell(root, workload), seed, 0.2, False, CPU, 0.0, root=root,
                       log=lambda *a: None)


@contextlib.contextmanager
def replaced(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def altered_label():
    """The labels kernel's output with one pixel's label changed."""
    from deplex_tpu_torch.kernels import labels

    original = labels.pixel_labels

    def pixel_labels(*args, **kw):
        out = original(*args, **kw).clone()
        flat = out.view(-1)
        flat[flat.numel() // 2] += 1
        return out
    return replaced(labels, "pixel_labels", pixel_labels)


def half_batch():
    """The entry computing the first half of a batch; the rest left 0."""
    from deplex_tpu_torch.parallel import batch

    original = batch.extract_depth_batch_jit

    def extract(depth, intrinsics, *, config):
        h = max(1, depth.shape[0] // 2)
        out = original(depth[:h], intrinsics, config=config)
        return torch.cat([out, torch.zeros((depth.shape[0] - h, *out.shape[1:]),
                                           dtype=out.dtype)])
    return replaced(batch, "extract_depth_batch_jit", extract)


def state_unchanged():
    """RANSAC's chunk step that leaves its state as it was."""
    from deplex_tpu_torch.kernels import ransac

    return replaced(ransac, "chunk_step", lambda *args, **kw: None)


@pytest.mark.parametrize("workload", list(SMALL))
def test_the_program_as_it_is_is_correct(root, workload):
    out = _run(root, workload)
    assert out["correct"] is True and out["failed"] == 0
    assert out["compared"]["mismatched_px"]["value"] == 0
    assert out["compared"]["frames_judged"]["value"] >= 1
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("workload", list(SMALL))
def test_the_control_is_not_correct(root, workload):
    out = control.control_run(_cell(root, workload), 17, 0.2, CPU, log=lambda *a: None)
    assert out["correct"] is False
    assert out["compared"]["mismatched_px"]["value"] > 0


@pytest.mark.parametrize("workload,fault", [
    ("tum_default.resident_b64", altered_label), ("tum_default.camera_b1", altered_label),
    ("tum_ransac.resident_b8", altered_label), ("tum_default.resident_b64", half_batch),
    ("tum_ransac.resident_b8", state_unchanged)])
def test_a_fault_underneath_is_not_correct(root, workload, fault):
    with fault():
        out = _run(root, workload)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["compared"]["mismatched_px"]["value"] > 0
