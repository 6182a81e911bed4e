"""Batches resident on the card, driven closed loop through
``parallel.batch.extract_depth_batch_jit``: each call is enqueued as soon as
the host is free, the uint8 labels stay on the card, and the window ends at
the final synchronize. The ring of distinct batches is larger than the
card's 50 MB L2, so no call finds its input in the cache.

Mix keys: ``batch`` frames a call, ``ring_batches`` distinct batches the
calls cycle through, ``sample_calls`` calls whose labels are judged,
``trace_calls`` calls a traced run profiles.
"""

from __future__ import annotations

import torch

from benchmark import frames
from benchmark.drivers import Reservoir, Window, sync


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.batch, self.ring_batches = int(t["batch"]), int(t["ring_batches"])
        self.sample = Reservoir(seed, int(t["sample_calls"]))
        self.trace_calls = int(t["trace_calls"])

    def setup(self) -> None:
        from deplex_tpu_torch.parallel import batch

        B, H, W = self.batch, self.cell.height, self.cell.width
        ring = frames.rolled_ring(self.cell.frame, self.ring_batches * B, self.seed, self.device)
        self.ring = list(ring.reshape(self.ring_batches, B, H, W).unbind(0))
        self.K = torch.as_tensor(self.cell.intrinsics, device=self.device)
        self.entry = batch.extract_depth_batch_jit
        cfg = self.cell.program_config()
        for _ in range(2):           # the first call records the graph; the second replays
            self.entry(self.ring[0], self.K, config=cfg)
        sync(self.device)
        self.cfg = cfg

    def window(self, w: Window) -> dict:
        entry, ring, K, cfg, n = self.entry, self.ring, self.K, self.cfg, self.ring_batches
        calls = 0
        w.begin()
        while w.running():
            with w.span(calls):
                out = entry(ring[calls % n], K, config=cfg)
            self.sample.offer(calls, (calls % n, out))
            w.after_call(calls)
            calls += 1
        seconds = w.end(calls)
        return {"seconds": seconds, "calls": calls, "frames": calls * self.batch}

    def judged(self) -> list:
        """(ring index, input frames, their labels) of each sampled call."""
        return [(r, self.ring[r], out) for _, (r, out) in self.sample.items()]

    def close(self) -> None:
        self.ring = self.entry = None
