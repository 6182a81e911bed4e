"""One camera, closed loop: ``PlaneExtractor.process_depth`` on a host
uint16 frame and the camera's numpy intrinsics, int32 labels back in host
memory; the next frame goes as soon as the labels are back. Frames cycle
through a host ring.

Each call's latency, from the call to its labels on the host, is read on
the card's clock: an event recorded on the stream before the call and one
after it returns. Between calls the card is idle (the call ends in a
blocking copy of the labels), so each event runs as soon as the host
records it and the two bracket the host's call; the host clock is not read
per call. One pair of events, made before the window, serves every call.
On the CPU (the harness's tests) the host clock stands in.

Mix keys: ``ring_frames`` distinct host frames, ``sample_calls`` calls
whose labels are judged, ``trace_calls`` calls a traced run profiles.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import frames
from benchmark.drivers import Reservoir, Window, sync


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.ring_frames = int(t["ring_frames"])
        self.sample = Reservoir(seed, int(t["sample_calls"]))
        self.trace_calls = int(t["trace_calls"])

    def setup(self) -> None:
        from deplex_tpu_torch import PlaneExtractor

        ring = frames.rolled_ring(self.cell.frame, self.ring_frames, self.seed, self.device)
        self.ring_dev = ring
        host = ring.view(torch.int16).cpu().numpy().view(np.uint16)
        self.ring = [np.ascontiguousarray(f) for f in host]
        self.K = np.asarray(self.cell.intrinsics, np.float32)
        self.extractor = PlaneExtractor(self.cell.height, self.cell.width,
                                        self.cell.program_config(), device=self.device)
        for i in range(3):           # the first call records the graph
            self.extractor.process_depth(self.ring[i], self.K)
        sync(self.device)

    def window(self, w: Window) -> dict:
        process, ring, K, n = self.extractor.process_depth, self.ring, self.K, self.ring_frames
        card = self.device.type == "cuda"
        if card:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        lat = []
        calls = 0
        w.begin()
        while w.running():
            if card:
                a.record()
            else:
                t = time.perf_counter()
            with w.span(calls):
                labels = process(ring[calls % n], K)
            if card:
                b.record()
                b.synchronize()
                lat.append(a.elapsed_time(b))
            else:
                lat.append(1e3 * (time.perf_counter() - t))
            self.sample.offer(calls, (calls % n, labels))
            w.after_call(calls)
            calls += 1
        seconds = w.end(calls)
        return {"seconds": seconds, "calls": calls, "frames": calls, "latencies_ms": lat}

    def judged(self) -> list:
        return [(r, self.ring_dev[r:r + 1], torch.from_numpy(labels)[None])
                for _, (r, labels) in self.sample.items()]

    def close(self) -> None:
        self.extractor = None
