"""The compiled entry's host time a camera call: the median over the traced
calls of the summed durations of the program's ``entry`` spans in each call
(``pipeline.compiled_planes``: the precision scope, the key, the input's
load, the graph's launch and the outputs' copies), in ms. None where the
trace holds no such span."""

import statistics

from benchmark import trace

SPAN = "entry"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    per = [sum(o.end - o.start for o in ops if o.name == SPAN)
           for ops in trace._by_call(tr.host, tr.calls) if any(o.name == SPAN for o in ops)]
    return statistics.median(per) / 1e3 if per else None
