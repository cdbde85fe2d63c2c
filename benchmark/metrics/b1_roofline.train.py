"""Kernel B1's share of its roofline at the training launch, the dither's
noise read with the samples: the mean least time of its launches in the
traced window (``flops/b1.py`` at each launch's shape) over the mean
device time of a ``fbank_kernel`` launch in the trace, in %."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    bounds = run.tail.get("b1_bound_s")
    times = run.trace.op_seconds("fbank_kernel")
    if not bounds or not times:
        return None
    return (sum(bounds) / len(bounds)) / (sum(times) / len(times)) * 100
