"""The device's idle share while the cell runs unprofiled: 100 x (1 - the
device's busy time a call, from the traced stretch, x the calls a second of
the rest of the window). The profiler slows the host's side of the calls it
records, so the traced stretch's own wall time would count that as idle."""

from benchmark import trace


def read(run):
    if run.trace is None:
        return None
    return trace.idle_pct(trace.busy_per_call_us(run.trace), *run.untraced())
