"""The configured stages' least time a call (``benchmark.costs``: bytes over
3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is longer, for
each stage, summed) over the device's busy time a call in the traced
stretch, in percent. It divides by the whole call's busy time, not by named
kernels, so a fusion or a rename leaves it the same measure."""

from benchmark import trace


def read(run):
    tr = run.trace
    if tr is None or run.least_s is None or not tr.n_calls:
        return None
    busy_s = trace.busy_us(tr.device) / 1e6 / tr.n_calls
    return 100.0 * run.least_s / busy_s if busy_s > 0 else None
