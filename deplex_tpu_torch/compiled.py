"""The compiled entry points: each program the JAX package jits, as a CUDA graph.

The JAX package runs every public entry point as one compiled program
(``extract_planes_jit`` and its kin, ``PlaneSlam``'s ``frame_fn`` and
``_pair_measure_fn``, and the ``fori_loop`` of ``run_ba`` and of
``optimize_pose_graph``). Here the counterpart of that layer is a
``torch.cuda.CUDAGraph`` per call signature: the kernels of ``csrc/``
(launched through their ctypes wrappers on the current stream) and the
plain-op glue around them, or a backend's whole loop of plain ops, are
recorded once and then replayed with one launch. The plane entries record
all six stages: RANSAC's loop runs its fixed number of chunks, the early
exit happens on the device, and the default draws are a graph input.
The entries: the five
``*_jit`` functions of ``pipeline`` and ``parallel.batch``,
"PlaneSlam.frame_fn", "PlaneSlam.pair_measure_fn", "run_ba" (``slam.ba``)
and "optimize_pose_graph" (``slam.pose_graph``).

    out = compiled.call("extract_planes_jit", fn, (points,), static)

* **The key** is what ``jax.jit`` keys on plus what a graph freezes: the
  entry point's name, its static arguments (the ``Config``, the image size,
  a backend's iteration count, ...), every input's shape, dtype and device.
  Equal keys share one graph. The intrinsics are an input (K1 reads them
  from device memory), so every camera replays the same graph.
* **The first call at a key** runs ``fn`` eagerly and returns its result:
  it builds the kernel library at first use, creates the cuBLAS and
  cuSOLVER handles and sets the kernels' shared-memory attributes. Then
  ``fn`` is recorded on a side stream into a graph with a private memory
  pool, inside ``pipeline.full_float32``: a graph is TF32-off whatever the
  caller's flags were when it was recorded.
* **Entries whose shapes move** (``eager_once``: the SLAM backends, whose
  keyframe and edge axes grow with the map) run eagerly only at the entry's
  first call on a card since ``clear()``, and record nothing then: a caller
  that calls once pays the eager call alone. Every later new key is
  recorded at once, with no eager run before it (the handles and
  workspaces exist by then), and replayed. Their callers pad the moving
  axes to power-of-two buckets (``bucket``), so a growing map meets a few
  keys, each many times. A backend's recording takes 1-3 s on an H100;
  the main path's take 0.01-0.07 s and its keys repeat every frame, so it
  keeps the eager run and the recording at each key's first call.
* **Every later call** copies its inputs into the graph's static input
  buffers, replays the graph on the current stream, and returns fresh
  copies of the outputs (the next replay overwrites the static ones).
* **The cache** is bounded by count and by bytes: a graph's pool keeps the
  peak of its recorded run (``Graph.pool_bytes``; ``graphs()`` lists each
  graph's, and the benchmark's runs print their sum as
  ``graph_pool_bytes``: on an H100 37.7 MB for the SLAM step, 25.2 MB
  for a B=1 frame, 52.4 MB at TUM B=64, 191 MB at ICL B=64), so past
  ``MAX_GRAPHS`` graphs, or past ``MAX_POOL_SHARE`` of a card's memory in
  the pools of its graphs, the least recently used go. The newest graph
  always stays.
* **On the CPU** nothing is recorded: ``fn`` runs (the plain twins). On a
  card, a capture or replay that fails raises; nothing runs eagerly instead.
  A recording that fails ends its pool's routing before it raises (torch's
  ``capture_end`` raises first, and the allocator would otherwise keep
  routing to the dead pool and stop recycling memory used across streams).
* **Spans** (``profiling.annotate``, while a torch profiler records):
  ``entry.key`` (the specs and the lookup), then ``entry.load``,
  ``entry.replay`` and ``entry.fresh`` on a replay, or ``entry.eager`` and
  ``entry.capture`` at a key's first call.
* **Launch counts** (``kernels.launch_counts``) keep counting kernel
  executions on the card: an eager call adds one a launch, the
  recording adds nothing (the wrappers' counts made while it records are
  rolled back), and each replay adds what the graph recorded.

Nothing that waits on the host may run inside ``fn``: a host sync, or a
copy from pageable host memory, makes the capture fail (and so raise).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_map

from deplex_tpu_torch import kernels
from deplex_tpu_torch.profiling import annotate

# Graphs kept at once, and the share of a card's memory that the pools of its
# graphs may hold together (a pool keeps its recorded run's peak; with 0.25
# an 80 GB card keeps eight TUM B=64 graphs, or two ICL B=64 ones).
MAX_GRAPHS = 8
MAX_POOL_SHARE = 0.25


@dataclasses.dataclass
class Graph:
    """One recorded call signature."""

    key: tuple
    graph: Any                     # torch.cuda.CUDAGraph
    inputs: tuple                  # static input buffers, filled before each replay
    outputs: Any                   # static outputs, in fn's output structure
    launches: dict                 # kernel launches one replay makes, by kernel name
    pool_bytes: int                # device memory reserved while recording
    capture_s: float               # seconds to record (the eager call not included)
    replays: int = 0

    def load(self, inputs, non_blocking: bool = False) -> None:
        """Copy `inputs` into the static input buffers (current stream)."""
        with annotate("entry.load"):
            for dst, src in zip(self.inputs, inputs):
                _copy(dst, src, non_blocking)

    def replay(self) -> None:
        """Replay on the current stream; the static outputs then hold this
        replay's results until the next one."""
        with annotate("entry.replay"):
            self.graph.replay()
            self.replays += 1
            for name, n in self.launches.items():
                kernels.MODULES[name].launches += n

    def fresh(self):
        """Copies of the static outputs, in fn's output structure."""
        with annotate("entry.fresh"):
            return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                            self.outputs)


_graphs: collections.OrderedDict = collections.OrderedDict()
_warm: set = set()                  # (entry, device) of eager_once entries that ran


def captures(device) -> bool:
    """Whether calls on `device` are recorded (a card) or run eagerly."""
    return torch.device(device).type == "cuda"


def new_graph():
    """An empty graph to record into."""
    return torch.cuda.CUDAGraph()


def spec(t: torch.Tensor) -> tuple:
    """What the key holds of one input."""
    return spec_of(t.shape, t.dtype, t.device)


def spec_of(shape, dtype, device) -> tuple:
    """What the key holds of an input of this shape and dtype on `device`
    (a card without an index is the current one)."""
    device = torch.device(device)
    index = device.index
    if device.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return tuple(shape), dtype, device.type, index


def bucket(n: int, least: int = 8) -> int:
    """The padded length of an axis of n: max(least, the next power of two)."""
    return max(least, 1 << (n - 1).bit_length())


def cache_key(entry: str, static, specs) -> tuple:
    """The key of a call: entry point, static arguments, input specs."""
    return entry, static, tuple(specs)


def lookup(entry: str, static, specs) -> Graph | None:
    """The graph recorded for this key, if any (marked most recently used)."""
    key = cache_key(entry, static, specs)
    graph = _graphs.get(key)
    if graph is not None:
        _graphs.move_to_end(key)
    return graph


def graphs() -> list:
    """The cached graphs, least recently used first."""
    return list(_graphs.values())


def pool_bytes(device=None) -> int:
    """Bytes the cached graphs' pools hold (on `device`, or on every card)."""
    return sum(g.pool_bytes for g in _graphs.values()
               if device is None or g.inputs[0].device == torch.device(device))


def clear() -> None:
    """Drop every graph (their pools go back to the caching allocator); an
    eager_once entry's next call runs eagerly again."""
    _graphs.clear()
    _warm.clear()


def call(entry: str, fn: Callable, inputs, static=(), *, eager_once: bool = False):
    """fn(*inputs), recorded and replayed as described in the module
    docstring; `static` holds every argument fn closes over that a graph
    freezes. Returns fn's output structure with fresh tensors."""
    inputs = tuple(inputs)
    if not captures(inputs[0].device):
        return fn(*inputs)
    with annotate("entry.key"):
        specs = [spec(t) for t in inputs]
        graph = lookup(entry, static, specs)
    if graph is not None:
        graph.load(inputs)
    elif eager_once and (entry, specs[0][2:]) in _warm:
        graph = capture(entry, fn, inputs, static)
    else:
        with annotate("entry.eager"):
            out = fn(*inputs)
        if eager_once:
            _warm.add((entry, specs[0][2:]))
        else:
            capture(entry, fn, inputs, static)
        return out
    graph.replay()
    return graph.fresh()


def capture(entry: str, fn: Callable, inputs, static=()) -> Graph:
    """Record fn on static copies of `inputs` and cache the graph."""
    from deplex_tpu_torch.pipeline import full_float32

    with annotate("entry.capture"):
        dev = inputs[0].device
        key = cache_key(entry, static, [spec(t) for t in inputs])
        static_in = tuple(_copy(torch.empty_like(t), t) for t in inputs)
        saved = kernels.launch_counts()
        graph, pool = new_graph(), _new_pool()
        _synchronize(dev)
        reserved = _reserved(dev)
        t0 = time.perf_counter()
        try:
            with _side_stream(dev), full_float32(dev):
                graph.capture_begin(pool=pool)
                try:
                    outputs = fn(*static_in)
                finally:
                    try:
                        graph.capture_end()
                    except BaseException:
                        _end_routing(dev, pool)
                        raise
        finally:
            recorded = {name: n - saved[name] for name, n in kernels.launch_counts().items()}
            for name, n in saved.items():
                kernels.MODULES[name].launches = n
        entry_graph = Graph(key=key, graph=graph, inputs=static_in, outputs=outputs,
                            launches=recorded, pool_bytes=_reserved(dev) - reserved,
                            capture_s=time.perf_counter() - t0)
        _graphs[key] = entry_graph
        _evict(dev)
        return entry_graph


def _evict(dev) -> None:
    """Drop the least recently used graphs past MAX_GRAPHS, then those of
    `dev` while their pools hold more than MAX_POOL_SHARE of its memory;
    the newest graph stays."""
    while len(_graphs) > MAX_GRAPHS:
        _graphs.popitem(last=False)
    budget = MAX_POOL_SHARE * _card_bytes(dev)
    older = [k for k, g in _graphs.items() if g.inputs[0].device == dev][:-1]
    for key in older:
        if pool_bytes(dev) <= budget:
            break
        del _graphs[key]


def _copy(dst: torch.Tensor, src: torch.Tensor, non_blocking: bool = False) -> torch.Tensor:
    """dst.copy_(src); uint16 (few ops take it) through int16 views."""
    if dst.dtype == torch.uint16:
        dst.view(torch.int16).copy_(src.view(torch.int16), non_blocking=non_blocking)
    else:
        dst.copy_(src, non_blocking=non_blocking)
    return dst


def _synchronize(dev) -> None:
    torch.cuda.synchronize(dev)


def _reserved(dev) -> int:
    return torch.cuda.memory_reserved(dev)


def _card_bytes(dev) -> int:
    return torch.cuda.get_device_properties(dev).total_memory


def _new_pool():
    """A private memory pool for one graph."""
    return torch.cuda.graph_pool_handle()


def _end_routing(dev, pool) -> None:
    """What a failed recording leaves behind: torch's ``capture_end`` raises
    before it stops the allocator routing the stream's allocations to
    `pool`, and while any routing is on, the allocator recycles no block
    used across streams. End it and release the pool. If torch had ended
    the routing itself (it failed later), there is nothing to undo."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:
        return
    torch._C._cuda_releasePool(index, pool)


def _side_stream(dev):
    """The recording stream: a graph is captured off the legacy default
    stream, after the work already queued on the current one. The current
    stream comes back on exit, a failed capture included."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    return torch.cuda.stream(side)
