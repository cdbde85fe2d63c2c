"""Device kernels launched per optimizer update in the traced window."""


def read(run):
    if run.trace is None or not run.tail.get("updates"):
        return None
    return run.trace.kernel_count() / run.tail["updates"]
