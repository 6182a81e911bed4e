"""The traced part of a window: ``torch.profiler`` over a run of the cell's
own calls, reduced to plain intervals, and the arithmetic the per-layer
metrics share.

A ``Trace`` holds, in microseconds on the profiler's one clock: the device
operations (kernels, copies, sets; not the annotation ranges the program
opens, which the device timeline shows as spans), the host's operations
and runtime calls, the harness's own span around each call into the
program (``CALL_SPAN``), the traced window's wall time by the host clock,
and how many calls it held. The union of the device intervals
is the device's busy time (the arithmetic of
``deplex_tpu_torch/tools/profile_path.py``'s ``_busy_us``). The profiler
slows the host's side of the calls it records, so the idle shares set the
trace's busy time a call against the calls outside the traced stretch.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
import time

import torch

# The harness's span around each call into the program.
CALL_SPAN = "bench.call"


@dataclasses.dataclass
class Op:
    name: str
    start: float        # us
    end: float          # us
    corr: int = 0       # the profiler's correlation id: a launch and what it put on the device


@dataclasses.dataclass
class Trace:
    device: list         # Op: device operations
    host: list           # Op: host operations and runtime calls
    calls: list          # Op: the CALL_SPAN spans, one a call
    wall_us: float       # the traced window by the host clock
    n_calls: int


def busy_us(ops) -> float:
    """The union of the intervals' lengths, in microseconds."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted((o.start, o.end) for o in ops):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def busy_per_call_us(tr: Trace) -> float | None:
    """The device's busy time in the traced stretch over its calls."""
    if not tr.device or not tr.n_calls:
        return None
    return busy_us(tr.device) / tr.n_calls


def idle_pct(busy_call_us: float | None, calls: int, seconds: float) -> float | None:
    """100 x (1 - busy a call x calls / seconds): the device's idle share
    of `calls` calls that took `seconds`, each keeping it busy for
    `busy_call_us` (read from the trace)."""
    if busy_call_us is None or calls <= 0 or seconds <= 0:
        return None
    return 100.0 * (1.0 - busy_call_us * 1e-6 * calls / seconds)


def gaps(ops) -> list[tuple[float, float]]:
    """The idle intervals between the union of the device intervals."""
    out, end = [], None
    for s, e in sorted((o.start, o.end) for o in ops):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def _call_at(calls, starts, t: float) -> int | None:
    """The index of the call whose span holds time t, if any."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and calls[i].end >= t else None


def _by_call(ops, calls) -> list[list]:
    """The operations that start inside each call's span, call by call."""
    starts = [c.start for c in calls]
    out = [[] for _ in calls]
    for o in ops:
        i = _call_at(calls, starts, o.start)
        if i is not None:
            out[i].append(o)
    return out


def covering(ops, t: float) -> str | None:
    """The innermost (shortest) of `ops` that spans time t, if any."""
    best = None
    for o in ops:
        if o.start <= t <= o.end and (best is None or o.end - o.start < best.end - best.start):
            best = o
    return best.name if best is not None else None


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[name, seconds a call] of the device's idle time by what the host was
    doing in each gap: the innermost host operation over the gap's middle,
    the harness's span (Python inside a call between operations) where
    none is, the harness's loop outside every call. The longest first."""
    starts = [c.start for c in tr.calls]
    inside = _by_call(tr.host, tr.calls)
    outside = [o for o in tr.host if _call_at(tr.calls, starts, o.start) is None]
    by = {}
    for s, e in gaps(tr.device):
        t = 0.5 * (s + e)
        i = _call_at(tr.calls, starts, t)
        name = covering(outside if i is None else inside[i], t)
        if name is None:
            name = CALL_SPAN if i is not None else "harness loop"
        by[name] = by.get(name, 0.0) + (e - s)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], us / 1e6 / tr.n_calls] for name, us in rows]


def ops_per_call(tr: Trace) -> float | None:
    """The median over the traced calls of the device operations each call
    launched: an operation belongs to the call whose span holds the host's
    launch of it (the host operation with its correlation id). A record the
    profiler drops moves no median."""
    if not tr.calls or not tr.device:
        return None
    starts = [c.start for c in tr.calls]
    launched = {}
    for o in tr.host:
        if o.corr:
            launched.setdefault(o.corr, o.start)
    per = [0] * len(tr.calls)
    for o in tr.device:
        i = _call_at(tr.calls, starts, launched.get(o.corr, -float("inf")))
        if i is not None:
            per[i] += 1
    return float(statistics.median(per))


def device_ops(tr: Trace, top: int = 10) -> list:
    """[name, seconds a call] of the device operations with the most time."""
    by = {}
    for o in tr.device:
        by[o.name] = by.get(o.name, 0.0) + (o.end - o.start)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], us / 1e6 / tr.n_calls] for name, us in rows]


class Profile:
    """torch.profiler around a stretch of calls: ``start()``, the calls
    (each inside ``call()``), ``stop(n_calls)`` -> Trace."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._t0 = None

    @staticmethod
    def warm() -> None:
        """Start the profiler once on a tiny op, so that its own set-up is
        not paid inside the window."""
        p = Profile()
        p.start()
        torch.ones(1, device="cuda").add_(1)
        p.stop(1)

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.start()
        self._t0 = time.perf_counter()

    @staticmethod
    def call():
        """The harness's span around one call into the program."""
        return torch.profiler.record_function(CALL_SPAN)

    def stop(self, n_calls: int) -> Trace:
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - self._t0)
        self._prof.stop()
        device, host, calls = [], [], []
        for e in self._prof.profiler.kineto_results.events():
            op = Op(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3, e.correlation_id())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append(op)
            elif e.name() == CALL_SPAN:
                calls.append(op)
            else:
                host.append(op)
        calls.sort(key=lambda o: o.start)
        return Trace(device, host, calls, wall_us, n_calls)
