"""Hand-written CUDA kernels for the H100 and their PyTorch wrappers.

    cellstats  -- stage-1 per-cell moments      (csrc/cellstats.cu)
    cellfinal  -- stage-1 fit, gates, normal bins and packed edges
                                                 (csrc/cellfinal.cu)
    growing    -- stage-3 region-growing rounds  (csrc/growing.cu)
    rounds     -- stage-3 round sums (fixed tree order), fits, gates, slots,
                  labels                          (csrc/rounds.cu)
    merge      -- stage-4 greedy plane merge     (csrc/merge.cu)
    labels     -- stage-5 pixel labels, with stage 6's final pass, in the
                  output dtype                    (csrc/labels.cu)
    sampling   -- stage-6 sampling: merged cell labels, the cells in plane
                  order, the hypotheses, the loop's first state
                                                 (csrc/sampling.cu)
    ransac     -- stage-6 RANSAC chunk scoring   (csrc/ransac.cu)

Each wrapper runs its kernel for CUDA tensors (or raises) and the plain
PyTorch twin for CPU tensors, and counts its kernel launches in a module
integer ``launches``. Each module's ``launch(lib, ..., stream)`` is the one
caller of its C entries: it passes checked inputs, outputs and the launch
geometry in the C signature's order (``_build._SIGNATURES``) and returns the
CUDA error code; the wrappers and ``tools/kernel_bench.py`` call it. Importing this package builds nothing: the library is
compiled at the first launch (``_build.library``).
"""

from deplex_tpu_torch.kernels import (cellfinal, cellstats, growing, labels, merge, ransac, rounds,
                                      sampling)

MODULES = {"cell_moments": cellstats, "cell_finalize": cellfinal, "grow_rounds": growing,
           "round_finalize": rounds, "merge_planes": merge, "pixel_labels": labels,
           "ransac_sampling": sampling, "ransac_scores": ransac}
# The kernels every extraction launches, once a call (stages 1-5 are K1 ->
# cell finalize -> K2 -> round finalize -> K3 -> pixel labels; the
# primitives path launches pixel_labels twice); ransac_sampling (once a
# call) and ransac_scores (once a chunk) run with stage 6 only.
PLANE_KERNELS = ("cell_moments", "cell_finalize", "grow_rounds", "round_finalize",
                 "merge_planes", "pixel_labels")


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: mod.launches for name, mod in MODULES.items()}


def reset_launch_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0
