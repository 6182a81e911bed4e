"""latency_p95_ms: the 95th percentile (linear between order statistics)
over every call in the window of the time from the call to its labels on
the host."""

import numpy as np


def read(run):
    lat = run.window.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
