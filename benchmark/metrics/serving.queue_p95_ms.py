"""95th percentile over the untraced part of the window of how late the
benchmark's one feeding thread started each piece after it was due: the
wait in front of the engine, which serves one feed at a time, in ms."""
import numpy as np


def read(run):
    late = run.head.get("late_s")
    if not late:
        return None
    return float(np.percentile(np.asarray(late), 95) * 1e3)
