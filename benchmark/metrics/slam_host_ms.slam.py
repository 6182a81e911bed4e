"""The SLAM cell's host I/O a call, in ms, on the host's clock alone: the
median over the traced calls of the program's ``io.upload`` spans'
durations (the depth's copy to the card, ``pipeline.depth_tensor``) plus
its ``slam.download`` span (the pose's and the keyframe's copies to the
host and their bookkeeping, ``PlaneSlam.process_frame``) from the return
of its first runtime copy (``cudaMemcpyAsync``) to the span's end. That
first copy waits for the step's replay, which is the device's time and is
left out, as ``io_host_ms.camera`` leaves out the labels' wait; its own
transfer of 36 bytes goes with it. No device timestamp is compared with a
host span: on the H100 the profiler's two clocks drift apart by ~0.6 ms
a second, 1.5 ms over a stretch of 300 traced calls. A call whose
download has no runtime copy is left out. None where no call has both
spans (a program without them)."""

import statistics

from benchmark import trace


def _first_copy_end(span, ops):
    """When the first ``cudaMemcpyAsync`` inside `span` returned, or None."""
    copies = [o for o in ops if o.name == "cudaMemcpyAsync" and span.start <= o.start <= span.end]
    return min(copies, key=lambda o: o.start).end if copies else None


def read(run):
    tr = run.trace
    if tr is None:
        return None
    per = []
    for ops in trace._by_call(tr.host, tr.calls):
        up = [o for o in ops if o.name == "io.upload"]
        down = [o for o in ops if o.name == "slam.download"]
        waited = [_first_copy_end(d, ops) for d in down]
        if not up or not down or None in waited:
            continue
        per.append(sum(o.end - o.start for o in up) + sum(d.end - w for d, w in zip(down, waited)))
    return statistics.median(per) / 1e3 if per else None
