"""Device kernels launched per engine tick in the traced window."""


def read(run):
    if run.trace is None or not run.tail.get("ticks"):
        return None
    return run.trace.kernel_count() / run.tail["ticks"]
