"""Milliseconds a dispatch the device sat idle while the host drew the
next batch (``BatchPrefetcher.get()``) or uploaded its origins and
points: the traced window's idle gaps that the benchmark's ``draw`` and
``upload`` spans overlap most, over its dispatches. (A span itself would
mostly time the device: the upload from pageable memory waits for the
dispatch before it.)"""


def read(run):
    tr = run.trace
    if tr is None or "traced_steps" not in run.rec:
        return None
    gaps = tr.idle_by_span()
    dispatches = run.rec["traced_steps"] / run.cell.config["train"][
        "inner_steps"]
    return (gaps.get("draw", 0.0) + gaps.get("upload", 0.0)) / dispatches \
        * 1e3
