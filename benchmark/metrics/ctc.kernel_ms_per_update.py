"""Device time of kernel C1, the CTC lattice (``ctc_lattice_alpha`` and
``ctc_lattice_beta``), per update of the traced window, in ms. None where
the trace holds no such kernel, as for a program whose CTC loss has none."""


def read(run):
    if run.trace is None or not run.tail.get("updates"):
        return None
    times = run.trace.op_seconds("ctc_lattice")
    return sum(times) / run.tail["updates"] * 1e3 if times else None
