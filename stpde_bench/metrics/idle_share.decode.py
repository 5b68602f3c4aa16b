"""1 - the device's busy time a decode window (the union of its kernels',
copies' and fills' intervals in the trace) over the wall time a decode window
of the untraced window, in %. The traced window's own wall time would
count the tracer's overhead on the host (a CUDA graph's replay and every
eager launch take longer under it) as idle; the device's busy time is
what the trace reads right. Noise between the two windows can take it
just below 0 where the card is never idle."""


def read(run):
    tr, rec = run.trace, run.rec
    if tr is None or "traced_windows" not in rec or not rec.get("windows"):
        return None
    busy = tr.busy_s / rec["traced_windows"]
    wall = rec["window_s"] / rec["windows"]
    return (1 - busy / wall) * 100
