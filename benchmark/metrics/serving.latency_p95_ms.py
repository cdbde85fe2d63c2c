"""95th percentile over the pieces due in the untraced part of the window
of the time from a piece's due time to the return of its ``feed``, in ms;
a piece never fed counts as the minute the run waits for it."""
import numpy as np


def read(run):
    lat = run.head.get("latency_s")
    if not lat:
        return None
    return float(np.percentile(np.minimum(np.asarray(lat), 60.0), 95) * 1e3)
