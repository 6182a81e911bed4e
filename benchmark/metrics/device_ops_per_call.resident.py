"""Device operations (kernels, copies, sets) a call: the median over the
traced calls of what each replayed call put on the card, each operation
counted to the call that launched it."""

from benchmark import trace


def read(run):
    return trace.ops_per_call(run.trace) if run.trace is not None else None
