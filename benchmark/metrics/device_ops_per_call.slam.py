"""``device_ops_per_call.resident``'s reading on the SLAM cell: the median
over the traced calls of the device operations each ``process_frame`` call
launched (the depth's upload, ``backproject_device``'s operations, the
step's replay and the copies to the host)."""

from benchmark import harness


def read(run):
    return harness.reader("device_ops_per_call.resident")(run)
