"""The SLAM step's device time a call, in µs: the traced stretch's device
busy time without the plane kernels of stages 1-4 (K1, cell finalize, K2,
round finalize, K3: each engine of each, by its kernel's name below), over
its calls. What is left is the tracking: association, Gauss-Newton
odometry, the map's fusion and spawning, ``backproject_device``'s
operations, the graph's input loads and output clones, and the copies to
and from the host. None without a trace or device operations."""

from benchmark import trace

PLANE_KERNELS = ("cell_moments_band", "cell_moments_per_cell", "cell_finalize_kernel",
                 "grow_rounds_kernel", "round_finalize_kernel", "merge_warp_kernel",
                 "merge_block_kernel")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls or not tr.device:
        return None
    rest = [o for o in tr.device if not any(k in o.name for k in PLANE_KERNELS)]
    return trace.busy_us(rest) / tr.n_calls
