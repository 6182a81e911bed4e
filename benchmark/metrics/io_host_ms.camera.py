"""The host I/O's time a camera call: the median over the traced calls of
the program's ``io.upload`` spans' durations plus, for its ``io.download``
span, the part after the card started the labels' copy to the host, in
ms. That start is the device operation whose correlation id is a runtime
call's (a ``cuda*`` or ``cu*`` call) inside the span; the download's wait
for the replay before it is the device's time, in its busy share, and is
left out. A call whose download has no such copy in the trace is left
out, not guessed. None where no call has both spans."""

import statistics

from benchmark import trace


def _copy_start(span, host, started):
    """When the card started the first device operation of a runtime call
    inside `span`, or None."""
    starts = [started[o.corr] for o in host
              if o.corr in started and o.name.startswith("cu") and span.start <= o.start <= span.end]
    return min(starts) if starts else None


def read(run):
    tr = run.trace
    if tr is None:
        return None
    started = {}
    for o in tr.device:
        started[o.corr] = min(o.start, started.get(o.corr, o.start))
    per = []
    for ops in trace._by_call(tr.host, tr.calls):
        up = [o for o in ops if o.name == "io.upload"]
        down = [o for o in ops if o.name == "io.download"]
        copies = [_copy_start(d, ops, started) for d in down]
        if not up or not down or None in copies:
            continue
        per.append(sum(o.end - o.start for o in up) + sum(d.end - c for d, c in zip(down, copies)))
    return statistics.median(per) / 1e3 if per else None
