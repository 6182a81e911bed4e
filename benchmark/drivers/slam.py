"""One depth camera tracked by plane-landmark SLAM, closed loop: each call
is ``PlaneSlam.process_frame(backproject_device(depth_tensor(depth, dev),
K))`` on a host uint16 frame and the camera's intrinsics on the card (made
once), as ``examples/run_slam.py`` tracks a sequence; the next frame goes
when the call returns, its pose and keyframe on the host.

A session is a fresh ``PlaneSlam`` (the configuration's ``slam`` block:
``max_landmarks``, ``odom_iterations``, ``min_obs_weight``; the default
association gates) tracking one sequence of ``episode_frames`` frames from
an empty map and the identity pose. Sessions cycle through the mix's
``sequences``, each the configuration's frame warped along a trajectory
whose seed is drawn from the run's (``benchmark.sequence``). Set-up tracks
one whole session, which records the step's graph; every later session
replays it.

Each call's latency, from the depth's upload to ``process_frame``'s
return, is read on the card's clock with one pair of CUDA events, as the
camera driver reads it (the call ends in blocking copies, so the card is
idle between calls); on the CPU the host clock stands in.

The sample is a reservoir of ``sample_episodes`` whole sessions, each
(sequence index, its host frames, the ``FrameResult`` of every call, the
map's count at the session's end), kept as the calls returned them: nothing
is copied in the window. A session the window's end cuts short is not
judged.

Mix keys: ``sequences``, ``sample_episodes``, ``trace_calls``.
"""

from __future__ import annotations

import time

import torch

from benchmark import sequence
from benchmark.drivers import Reservoir, Window, sync


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.n_sequences = int(t["sequences"])
        self.sample = Reservoir(seed, int(t["sample_episodes"]))
        self.trace_calls = int(t["trace_calls"])
        self.episode_frames = int(cell.config["slam"]["episode_frames"])

    def setup(self) -> None:
        from deplex_tpu_torch import PlaneSlam, profiling
        from deplex_tpu_torch.pipeline import backproject_device, depth_tensor

        cell, dev = self.cell, self.device
        seeds = sequence.sequence_seeds(self.seed, self.n_sequences)
        self.sequences = sequence.sequences(cell.frame, cell.intrinsics, self.episode_frames,
                                            seeds)
        K = torch.as_tensor(cell.intrinsics, device=dev)
        slam = cell.config["slam"]
        config = cell.program_config()

        def session():
            return PlaneSlam(cell.height, cell.width, config,
                             max_landmarks=int(slam["max_landmarks"]),
                             odom_iterations=int(slam["odom_iterations"]),
                             min_obs_weight=float(slam["min_obs_weight"]), device=dev)

        def step(tracker, depth):
            return tracker.process_frame(backproject_device(depth_tensor(depth, dev), K))

        self.session, self.step = session, step
        warm = session()                 # the first call records the step's graph
        for depth in self.sequences[0]:
            step(warm, depth)
        sync(dev)
        reset = getattr(profiling, "reset_slam_counters", None)
        if reset is not None:
            reset()

    def window(self, w: Window) -> dict:
        session, step, seqs = self.session, self.step, self.sequences
        F, n = self.episode_frames, self.n_sequences
        card = self.device.type == "cuda"
        if card:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        lat, results = [], []
        calls = 0
        w.begin()
        while w.running():
            k, f = divmod(calls, F)
            if f == 0:
                tracker, results = session(), []
            if card:
                a.record()
            else:
                t = time.perf_counter()
            with w.span(calls):
                res = step(tracker, seqs[k % n][f])
            if card:
                b.record()
                b.synchronize()
                lat.append(a.elapsed_time(b))
            else:
                lat.append(1e3 * (time.perf_counter() - t))
            results.append(res)
            if f == F - 1:
                self.sample.offer(k, (k % n, results, tracker.map.count))
            w.after_call(calls)
            calls += 1
        seconds = w.end(calls)
        return {"seconds": seconds, "calls": calls, "frames": calls, "latencies_ms": lat}

    def judged(self) -> list:
        """(sequence index, its uint16 host frames, the session's
        FrameResults, the map's count at its end) of each sampled session."""
        return [(key, self.sequences[key], results, count)
                for _, (key, results, count) in self.sample.items()]

    def close(self) -> None:
        self.session = self.step = None
