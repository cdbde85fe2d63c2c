"""Device kernels launched per ``predict_batch`` call in the traced
window."""


def read(run):
    if run.trace is None or not run.tail.get("batches"):
        return None
    return run.trace.kernel_count() / run.tail["batches"]
