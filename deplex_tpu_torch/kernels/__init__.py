"""Hand-written CUDA kernels for the H100 and their PyTorch wrappers.

    cellstats  -- stage-1 per-cell moments      (csrc/cellstats.cu)
    growing    -- stage-3 region-growing rounds  (csrc/growing.cu)
    merge      -- stage-4 greedy plane merge     (csrc/merge.cu)

Each wrapper runs its kernel for CUDA tensors (or raises) and the plain
PyTorch twin for CPU tensors, and counts its kernel launches in a module
integer ``launches``. Importing this package builds nothing: the library is
compiled at the first launch (``_build.library``).
"""

from deplex_tpu_torch.kernels import cellstats, growing, merge

MODULES = {"cell_moments": cellstats, "grow_rounds": growing, "merge_planes": merge}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: mod.launches for name, mod in MODULES.items()}


def reset_launch_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0
