"""Share of the traced window in which no operation ran on the device
(1 − the union of device intervals over the window), in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1 - run.trace.busy_s / run.trace.window_s) * 100
