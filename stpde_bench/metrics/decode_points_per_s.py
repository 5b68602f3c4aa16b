"""Lattice points decoded in the window over its wall time; a point
counts once its window's output is on the host (host clock)."""


def read(run):
    if "points" not in run.rec:
        return None
    return run.rec["points"] / run.rec["window_s"]
