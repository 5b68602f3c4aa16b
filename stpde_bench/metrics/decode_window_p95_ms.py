"""The 95th percentile of every window's time, from the hand-over of its
low-res input to its output on the host (host clock)."""

import numpy as np


def read(run):
    lat = run.rec.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
