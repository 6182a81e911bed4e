"""Blocking copies to the host a frame: the program's SLAM host counters
over the window (``deplex_tpu_torch.profiling.slam_counters()``, zeroed at
the end of set-up): ``slam_host_reads / slam_frames``. None where the
program keeps no such counters or counted no frame."""


def read(run):
    from deplex_tpu_torch import profiling

    counters = getattr(profiling, "slam_counters", None)
    counts = counters() if counters is not None else {}
    frames = counts.get("slam_frames", 0)
    return counts.get("slam_host_reads", 0) / frames if frames > 0 else None
