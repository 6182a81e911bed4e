"""The one marshalling of each C entry (each ``kernels/<k>.py``'s ``launch``)
against the signatures that ``kernels/_build.py`` declares to ctypes.

No card runs here, so a fake library stands in for the built one: it
records every call with its arguments. Each case calls a module's
``launch`` on small CPU tensors and holds the recorded call to the entry's
declared signature: as many arguments as it declares, the stream included;
an int in every ``c_int`` slot, a float in every ``c_float`` slot, an int
or None in every ``c_void_p`` slot. The same holds for the launch that
``tools/kernel_bench.py``'s launcher of that kernel makes, which must reach
that same ``launch``.
"""

import ctypes

import pytest
torch = pytest.importorskip("torch")

from deplex_tpu_torch import Config
from deplex_tpu_torch.kernels import _build
from deplex_tpu_torch.kernels import cellfinal as k_final
from deplex_tpu_torch.kernels import cellstats as k_cells
from deplex_tpu_torch.kernels import growing as k_grow
from deplex_tpu_torch.kernels import labels as k_labels
from deplex_tpu_torch.kernels import merge as k_merge
from deplex_tpu_torch.kernels import ransac as k_ransac
from deplex_tpu_torch.kernels import rounds as k_rounds
from deplex_tpu_torch.kernels import sampling as k_sampling
from deplex_tpu_torch.ops.ransac import new_chunk_state
from deplex_tpu_torch.tools import kernel_bench as kb

STREAM = 0x5EED
# What the fake library's query entries answer.
QUERIES = {"dplx_grow_rounds_scratch_bytes": 64, "dplx_grow_rounds_counter_slots": 5,
           "dplx_round_finalize_scratch_bytes": 0, "dplx_round_finalize_max_clusters": 16,
           "dplx_ransac_sample_max_clusters": 16, "dplx_ransac_sample_fit_blocks_per_sm": 4}
B, GH, GW, P = 2, 3, 4, 4
H, W = GH * P, GW * P
CONFIG = Config(patch_size=P, max_planes=8, max_region_growing_rounds=16,
                ransac_max_iterations=40)


class FakeLibrary:
    """Stands in for the kernel library: every attribute is an entry that
    records its arguments; a launch entry returns 0, a query QUERIES'."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dplx_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return QUERIES.get(name, 0)
        return entry

    def launches(self):
        return [(name, args) for name, args in self.calls if name not in QUERIES]


def empty(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def segments():
    """Zeroed PlaneSegments of (B, MAXP) planes."""
    return k_rounds.outputs(B, GH, GW, CONFIG, torch.device("cpu"))[2]


def ransac_case() -> dict:
    """kernel_bench's chunk-step case, as ``kernel_bench.ransac_case`` keys it,
    on zeroed tensors: chunk 0 of 8 hypotheses of 40."""
    M, chunk = CONFIG.max_planes, 8
    return {"points": empty(B, H * W, 3), "cells": empty(B, GH, GW, dtype=torch.int32),
            "hyp": empty(B, M, CONFIG.ransac_max_iterations, 4),
            "order": empty(B, GH * GW, dtype=torch.int64),
            "bounds": empty(B, M + 2, dtype=torch.int64), "n_pts": empty(B, M),
            "ratio": torch.tensor(0.5), "chunk": chunk,
            "kw": dict(chunk=chunk, threshold=0.05, image_width=W, patch_size=P)}


def sampling_inputs():
    """(points, labels_map, merge_labels, W, P) of the sampler."""
    return (empty(B, H * W, 3), empty(B, GH, GW, dtype=torch.int32),
            empty(B, CONFIG.max_planes, dtype=torch.int32), W, P)


def call_moments(lib, points):
    if points:
        k_cells.launch(lib, empty(B, H, W, 3), None, CONFIG, empty(13, B, GH, GW), P, 1, STREAM)
    else:
        k_cells.launch(lib, empty(B, H, W, dtype=torch.uint16), empty(4), CONFIG,
                       empty(13, B, GH, GW), P, 0, STREAM)


def call_finalize(lib):
    k_final.launch(lib, empty(13, B, GH, GW), P, CONFIG,
                   k_final.outputs(B, GH, GW, torch.device("cpu")), GH, GW, STREAM)


def call_grow(lib):
    k_grow.launch(lib, empty(B, GH, GW, dtype=torch.int32), empty(B, GH, GW),
                  empty(B, GH, GW, dtype=torch.uint8), CONFIG,
                  *k_grow.outputs(B, GH, GW, CONFIG, torch.device("cpu")),
                  empty(64, dtype=torch.uint8), empty(4, dtype=torch.int64), STREAM)


def call_round_finalize(lib):
    stats = k_final.outputs(B, GH, GW, torch.device("cpu")).stats
    ints = (empty(B, GH, GW, dtype=torch.int32),
            empty(B, CONFIG.max_region_growing_rounds, dtype=torch.int32),
            empty(B, dtype=torch.int32))
    for scratch in (None, empty(64, dtype=torch.uint8)):
        k_rounds.launch(lib, *ints, stats, CONFIG,
                        *k_rounds.outputs(B, GH, GW, CONFIG, torch.device("cpu")), 2, STREAM,
                        scratch)


def call_merge(lib):
    seg = segments()
    tables = [getattr(seg, name) for name in k_merge.TABLES]
    for profile in (None, empty(B, 9, dtype=torch.int64)):
        k_merge.launch(lib, empty(B, GH, GW, dtype=torch.int32), seg.nr_planes, tables,
                       CONFIG, empty(B, CONFIG.max_planes, dtype=torch.int32),
                       [torch.empty_like(t) for t in tables], STREAM, profile)


def call_labels(lib):
    M = CONFIG.max_planes
    refine = (empty(B, H * W, 3), empty(B, M, 40, 4), empty(B, M, dtype=torch.int64), 0.05)
    for dtype, stage6 in ((torch.uint8, None), (torch.int32, refine)):
        k_labels.launch(lib, empty(B, GH, GW, dtype=torch.int32),
                        empty(B, M, dtype=torch.int32), H, W, P, empty(B, H * W, dtype=dtype),
                        STREAM, stage6)


def call_chunk_step(lib):
    c = ransac_case()
    state = new_chunk_state(c["n_pts"], c["ratio"], c["chunk"])
    for losses in (None, empty(B, CONFIG.max_planes, c["chunk"], dtype=torch.int32)):
        k_ransac.launch(lib, c["points"], c["cells"], c["hyp"], c["order"], c["bounds"], state,
                        0, c["chunk"], 0.05, H, W, P, k_ransac.run_cells(P), STREAM, losses)


def call_sample(lib):
    points, labels_map, merge_labels, _, _ = sampling_inputs()
    out = k_sampling.outputs(B, GH, GW, CONFIG, None, torch.device("cpu"))
    ranks = k_sampling.draws_input(None, None, B, CONFIG, torch.device("cpu"))
    for merged in (merge_labels, None):
        k_sampling.launch(lib, points, labels_map, merged, ranks, H, W, P, CONFIG, out, 2,
                          STREAM)


def bench_moments(lib):
    kb.moments_launcher(lib, empty(B, H, W, dtype=torch.uint16), torch.eye(3), CONFIG)[0]()


def bench_finalize(lib):
    kb.cells_launcher(lib, empty(13, B, GH, GW), P, CONFIG)[0]()


def bench_grow(lib):
    kb.rounds_launcher(lib, empty(B, GH, GW, dtype=torch.int32), empty(B, GH, GW),
                       empty(B, GH, GW, dtype=torch.uint8), CONFIG)[0]()


def bench_round_finalize(lib):
    stats = k_final.outputs(B, GH, GW, torch.device("cpu")).stats
    kb.round_launcher(lib, empty(B, GH, GW, dtype=torch.int32),
                      empty(B, CONFIG.max_region_growing_rounds, dtype=torch.int32),
                      empty(B, dtype=torch.int32), stats, CONFIG)[0]()


def bench_merge(lib):
    kb.merge_launcher(lib, empty(B, GH, GW, dtype=torch.int32), segments(), CONFIG)[0]()


def bench_labels(lib):
    kb.labels_launcher(lib, empty(B, GH, GW, dtype=torch.int32),
                       empty(B, CONFIG.max_planes, dtype=torch.int32), H, W, P)[0]()


def bench_chunk_step(lib):
    c = ransac_case()
    kb.ransac_launcher(lib, c, 0, kb.ransac_state(c, never_done=True))[0]()


def bench_sample(lib):
    kb.sampling_launcher(lib, *sampling_inputs(), CONFIG, cluster=2)[0]()


# entry -> (its module, a call of the module's launch, kernel_bench's launcher)
CASES = {
    "dplx_cell_moments_depth": (k_cells, lambda lib: call_moments(lib, False), bench_moments),
    "dplx_cell_moments_points": (k_cells, lambda lib: call_moments(lib, True), None),
    "dplx_cell_finalize": (k_final, call_finalize, bench_finalize),
    "dplx_grow_rounds": (k_grow, call_grow, bench_grow),
    "dplx_round_finalize": (k_rounds, call_round_finalize, bench_round_finalize),
    "dplx_merge_from_labels": (k_merge, call_merge, bench_merge),
    "dplx_pixel_labels": (k_labels, call_labels, bench_labels),
    "dplx_ransac_chunk_step": (k_ransac, call_chunk_step, bench_chunk_step),
    "dplx_ransac_sample": (k_sampling, call_sample, bench_sample),
}


def assert_matches_signature(entry: str, args: tuple) -> None:
    declared, _ = _build._SIGNATURES[entry]
    assert len(args) == len(declared), (entry, len(args), len(declared))
    assert args[-1] == STREAM, (entry, "the stream is not the last argument")
    for slot, (value, ctype) in enumerate(zip(args, declared)):
        if ctype is ctypes.c_int:
            ok = isinstance(value, int) and not isinstance(value, bool)
        elif ctype is ctypes.c_float:
            ok = isinstance(value, float)
        else:
            assert ctype is ctypes.c_void_p
            ok = value is None or (isinstance(value, int) and not isinstance(value, bool))
        assert ok, f"{entry}: argument {slot} is {value!r}, declared {ctype.__name__}"


@pytest.mark.parametrize("entry", sorted(CASES))
def test_launch_passes_the_declared_signature(entry):
    module, call, _ = CASES[entry]
    lib = FakeLibrary()
    call(lib)
    launched = lib.launches()
    assert launched and {name for name, _ in launched} == {entry}, launched
    for _, args in launched:
        assert_matches_signature(entry, args)


@pytest.mark.parametrize("entry", sorted(e for e, case in CASES.items() if case[2]))
def test_kernel_bench_launcher_reaches_the_same_launch(entry, monkeypatch):
    module, _, bench = CASES[entry]
    monkeypatch.setattr(kb, "_stream", lambda: STREAM)
    monkeypatch.setattr(k_final, "sm_count", lambda dev: 132)
    reached = []
    original = module.launch

    def spy(*args, **kwargs):
        reached.append(args[0])
        return original(*args, **kwargs)
    monkeypatch.setattr(module, "launch", spy)
    lib = FakeLibrary()
    bench(lib)
    assert reached == [lib]
    launched = lib.launches()
    assert [name for name, _ in launched] == [entry]
    assert_matches_signature(entry, launched[0][1])
