"""The share of the traced window in which the card waited for the host,
in %: 1 - the union of the kernel, copy and fill intervals in the trace
over the traced window's wall time. Under the tracer the host launches a
graph of ~10^5 nodes far more slowly than without it, so most of what
this reads idle is that launch (the breakdown's ``dispatch`` gaps); the
draw and the upload are ``batch_wait_ms.train``'s."""


def read(run):
    tr = run.trace
    if tr is None or "traced_steps" not in run.rec or not tr.window_s:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100
