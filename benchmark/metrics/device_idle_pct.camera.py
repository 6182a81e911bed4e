"""The device's idle share of a camera's calls: 100 x (1 - the device's
busy time a call, from the traced stretch, / the mean latency of the calls
outside it). The card idles between calls while the harness loops; that
time is in no call's latency, so it is left out."""

from benchmark import trace


def read(run):
    if run.trace is None:
        return None
    lat = run.untraced_latencies_ms()
    if not lat:
        return None
    return trace.idle_pct(trace.busy_per_call_us(run.trace), len(lat), sum(lat) / 1e3)
