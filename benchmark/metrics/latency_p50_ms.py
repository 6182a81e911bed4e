"""latency_p50_ms: the median, over every call in the window, of the time
from the call to its labels on the host (the camera driver's event pairs)."""

import statistics


def read(run):
    lat = run.window.get("latencies_ms")
    return statistics.median(lat) if lat else None
