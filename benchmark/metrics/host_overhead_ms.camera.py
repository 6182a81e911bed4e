"""What the compiled entry and the host I/O add to a camera's frame: the
median latency of the calls outside the traced stretch minus the device's
busy time a call in it, in ms."""

import statistics

from benchmark import trace


def read(run):
    if run.trace is None:
        return None
    lat, busy = run.untraced_latencies_ms(), trace.busy_per_call_us(run.trace)
    if not lat or busy is None:
        return None
    return statistics.median(lat) - busy / 1e3
