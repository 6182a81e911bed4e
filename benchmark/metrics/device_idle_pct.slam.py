"""``device_idle_pct.camera``'s formula on the SLAM cell: 100 x (1 - the
device's busy time a ``process_frame`` call, from the traced stretch, / the
mean latency of the calls outside it). The host's Python, its launches and
its syncs between the step's replay and the copies are the idle share."""

from benchmark import harness


def read(run):
    return harness.reader("device_idle_pct.camera")(run)
