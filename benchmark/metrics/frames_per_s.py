"""frames_per_s: the frames of every call in the window, all finished on the
card, over the seconds from the window's start to its final synchronize
(host clock)."""


def read(run):
    w = run.window
    return w["frames"] / w["seconds"] if w.get("frames") else None
