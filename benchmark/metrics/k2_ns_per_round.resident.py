"""K2's device time a call in the traced stretch (the kernel whose name holds
``grow_rounds_kernel``) over the rounds a frame took, in nanoseconds: the
program's stage-3 counters (``deplex_tpu_torch.profiling.counters()``:
rounds / frames, over the run's calls). A call's frames grow side by side,
so this is K2's time a dependent round, on one scale for every grid: a K2
change that helps one grid's rounds and slows another's shows here. None
where the trace holds no such kernel or the program keeps no counters."""

KERNEL = "grow_rounds_kernel"


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls:
        return None
    us = sum(o.end - o.start for o in tr.device if KERNEL in o.name)
    if us <= 0:
        return None
    from deplex_tpu_torch import profiling

    counters = getattr(profiling, "counters", None)
    counts = counters() if counters is not None else {}
    frames, rounds = counts.get("frames", 0), counts.get("rounds", 0)
    if frames <= 0 or rounds <= 0:
        return None
    return 1e3 * us / tr.n_calls / (rounds / frames)
