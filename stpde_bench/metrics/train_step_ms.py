"""The window's wall time over the optimizer steps completed in it (host
clock; the window ends with a device synchronise)."""


def read(run):
    if "steps" not in run.rec:
        return None
    return run.rec["window_s"] / run.rec["steps"] * 1e3
