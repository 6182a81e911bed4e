"""How a traffic mix drives the program: one module a driver kind, named
by the mix's ``"driver"`` key, each with a ``Driver`` class.

``Driver(cell, seed, device)``; ``setup()`` makes the inputs from the seed
and warms up the cell's shapes (the program's first call at a shape records
its graph); ``window(seconds, profile)`` drives the program for that long
and returns what it measured; ``judged()`` the samples of the calls a
seeded sample kept; ``close()`` lets the program's state go.

The samples are the contract between a driver and the judge that the
cell's configuration names (``benchmark/judges/<judge>.py``, ``labels``
without the key; ``benchmark.judge``): the harness hands ``judged()``'s
list to that judge's ``judge`` unread, so a driver and a judge agree on
its items' shape, and a new kind of output comes as a new driver and a new
judge. For the ``labels`` judge (the ``resident`` and ``camera`` drivers)
an item is (key of a distinct input batch, (B, H, W) uint16 input frames,
the (B, H*W) labels the program returned for them). The control's
stand-in (the judge's ``in_place_of_program``) replaces the program's
entry that the driver calls, so a driver looks its entry up at set-up or
at call time, never while its module is imported.
"""

from __future__ import annotations

import random
import time

import torch


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of k of a window's calls, drawn from the seed
    (reservoir sampling): ``offer(i, item)`` for the i-th call in order."""

    def __init__(self, seed: int, k: int):
        self._rng = random.Random(seed)
        self._slots: list = []
        self.k = k

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self._slots.append((i, item))
            return
        j = self._rng.randrange(i + 1)
        if j < self.k:
            self._slots[j] = (i, item)

    def items(self) -> list:
        """The kept (call index, item) pairs in call order."""
        return sorted(self._slots, key=lambda pair: pair[0])


class Window:
    """The window's clock and, in a traced run, the stretch it profiles:
    ``profile`` starts once `after` of the window's seconds have passed and
    covers `calls` calls. The stretch's calls and seconds, from just before
    the profiler starts to just after its trace is read, are kept apart
    (``stretch``), so that a metric can read the calls the profiler did not
    slow."""

    def __init__(self, seconds: float, device: torch.device, profile=None,
                 calls: int = 0, after: float = 0.5):
        self.seconds, self.device = seconds, device
        self.profile, self.profile_calls = profile, calls
        self.trace = None
        self.stretch = None             # (first call, calls, seconds) once profiled
        self._after = after * seconds
        self._first = None              # index of the first profiled call
        self._t_first = None

    def begin(self) -> None:
        sync(self.device)
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds

    def running(self) -> bool:
        return time.perf_counter() < self.deadline

    def span(self, i: int):
        """Around call i: starts the profile where due; the harness's span
        while it records."""
        p = self.profile
        if p is not None and self.stretch is None:
            if self._first is None and time.perf_counter() - self.t0 >= self._after:
                self._first, self._t_first = i, time.perf_counter()
                p.start()
            if self._first is not None:
                return p.call()
        return _NULL

    def after_call(self, i: int) -> None:
        if self._first is not None and self.stretch is None \
                and i + 1 - self._first >= self.profile_calls:
            self._stop(i + 1)

    def _stop(self, calls: int) -> None:
        self.trace = self.profile.stop(calls - self._first)
        self.stretch = (self._first, calls - self._first, time.perf_counter() - self._t_first)

    def end(self, calls: int) -> float:
        """The window's seconds up to the last call's end; a profile cut
        short by the deadline is stopped at the calls it covered."""
        sync(self.device)
        elapsed = time.perf_counter() - self.t0
        if self._first is not None and self.stretch is None:
            self._stop(calls)
        return elapsed


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()
