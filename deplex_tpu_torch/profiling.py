"""Stage-level tracing and timing.

Port of ``deplex_tpu.profiling``. The stage taxonomy of the reference's
benchmark log (cell grid, region growing, merge, labels, refinement) names
the ranges that ``pipeline.py`` opens with ``annotate`` around each stage,
and the host layers' spans around them (``io.upload``, ``entry``,
``entry.key``, ``entry.load``, ``entry.replay``, ``entry.fresh``,
``entry.eager``, ``entry.capture``, ``io.download``):
``torch.profiler.record_function`` ranges, opened only while a torch
profiler records, so that they land in its trace beside the card's
activity on one clock. ``stage_timings`` runs the stages one at a time and
times each: with CUDA events on the card, with ``time.perf_counter`` on
the CPU. ``counters`` reads what the stage-3 kernel counts as it runs (a
frame, its rounds, whether its staging took the radix sort, whether its
rounds ran one row a lane, the radix sort's passes), also inside recorded
graphs;
``reset_counters`` zeroes them. ``slam_counters`` reads what
``PlaneSlam.process_frame`` counts on the host (its frames, the
observations matched, its blocking copies to the host);
``reset_slam_counters`` zeroes them.

    with deplex_tpu_torch.profiling.trace("/tmp/trace"):
        extractor.process(points)      # then open the Chrome trace it wrote

    times = stage_timings(points, 480, 640, Config())   # {stage: seconds}
    profiling.counters()    # {"frames": ..., "rounds": ..., "radix_frames": ...,
                            #  "multiwarp_frames": ..., "radix_passes": ...}
    profiling.slam_counters()   # {"slam_frames": ..., "slam_matched": ...,
                                #  "slam_host_reads": ...}
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time

import torch

STAGES = ("cell_grid", "region_growing", "merge", "labels", "refinement")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside (host and, with a card, device activity) and
    write it as a Chrome trace, ``<log_dir>/trace_<pid>.json``; yields the
    ``torch.profiler.profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}.json"))


# What annotate returns while nothing records: one shared context that does
# nothing (a nullcontext keeps no state, so every span may reuse it).
_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named range: ``torch.profiler.record_function(name)`` while a torch
    profiler records (``trace``, the benchmark's traced runs), else one
    shared object that does nothing, so a span on the hot path costs a
    check and two empty calls. NVTX ranges, for nsys, come from running
    under ``torch.autograd.profiler.emit_nvtx()``: its profiler state makes
    every ``record_function`` range an NVTX range."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def counters() -> dict:
    """The stage-3 kernel's counts since the process started or the last
    ``reset_counters``, summed over the devices (each read with one copy to
    the host): ``frames`` grown, their ``rounds``, ``radix_frames``,
    those whose staging sorted the bins by radix (a frame too large for
    shared memory, or with bins too large to rank by comparisons), and
    ``multiwarp_frames``, those whose rounds ran one row a lane on several
    warps (``kernels.growing.multiwarp``: a frame that fits in shared
    memory, with 3 words a row, 129-192 columns, and at most 512 rows), and
    ``radix_passes``, the passes of those radix sorts
    (``kernels.growing.radix_passes``: a byte of the seed key that the
    counted cells differ in each, then the bins'), so that
    ``radix_passes / radix_frames`` is the passes a radix-staged frame. On
    the CPU the plain twin's outputs give the same counts."""
    from deplex_tpu_torch.kernels import growing

    return growing.read_counters()


def reset_counters() -> None:
    """Zero the stage-3 kernel's counts on every device."""
    from deplex_tpu_torch.kernels import growing

    growing.reset_counters()


def slam_counters() -> dict:
    """``PlaneSlam.process_frame``'s host counts since the process started
    or the last ``reset_slam_counters``: ``slam_frames`` processed,
    ``slam_matched``, the observations matched to a landmark (counted from
    the matches each frame copies to the host anyway, so no device work and
    no sync is added), and ``slam_host_reads``, the blocking copies to the
    host it made (6 a frame: the pose's R and t, the keyframe's normals,
    offsets, weights and matches)."""
    from deplex_tpu_torch.slam import frontend

    return dict(frontend.COUNTERS)


def reset_slam_counters() -> None:
    """Zero ``PlaneSlam.process_frame``'s host counts."""
    from deplex_tpu_torch.slam import frontend

    for key in frontend.COUNTERS:
        frontend.COUNTERS[key] = 0


def stage_timings(points, image_height: int, image_width: int, config=None,
                  repeats: int = 10, device=None) -> dict:
    """Mean seconds per call of each stage on one (H*W, 3) organized cloud,
    after a warm-up, on `device` (default: the card; ``"cpu"`` for the
    twins). Keys: ``STAGES``, ``refinement`` only when
    ``config.ransac_refinement``."""
    from deplex_tpu_torch.config import Config
    from deplex_tpu_torch.pipeline import (PlaneCells, check_patch, compute_cells,
                                           full_float32, grow_planes, merge_stage,
                                           refine_stage, resolve_device, write_labels)

    cfg = config if config is not None else Config()
    H, W = image_height, image_width
    check_patch(H, W, cfg)
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev).reshape(1, H, W, 3).contiguous()

    def s1():
        return compute_cells(pts, None, cfg)

    def s2():
        return grow_planes(cells, cfg)

    def s3():
        return merge_stage(lm, seg, cfg)

    def s4():
        return write_labels(PlaneCells(lm, ml), H, W, cfg)

    def s5():
        return refine_stage(PlaneCells(lm, ml, pts.reshape(1, -1, 3)), H, W, cfg)[0]

    def seconds(fn) -> float:
        fn()                                   # warm-up
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn()
            return (time.perf_counter() - t0) / repeats
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats

    with full_float32(dev):
        cells = s1()
        lm, seg = s2()
        ml = s3()
        out = {"cell_grid": seconds(s1), "region_growing": seconds(s2), "merge": seconds(s3),
               "labels": seconds(s4)}
        if cfg.ransac_refinement:
            out["refinement"] = seconds(s5)
    return out
