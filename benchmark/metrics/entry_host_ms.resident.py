"""``entry_host_ms.camera``'s reading on a resident cell: the host's time to
enqueue a call (the key, the input's load, the graph's launch, the outputs'
copies), against the device's busy time a call that the host must stay
under."""

from benchmark import harness


def read(run):
    return harness.reader("entry_host_ms.camera")(run)
