"""Host time of the calls into the port's CTC loss (the forward's alpha
loop; its backward runs inside the update's backward) per update, from the
benchmark's ``ctc`` spans in the trace, in ms."""


def read(run):
    if run.trace is None or not run.tail.get("updates"):
        return None
    spans = run.trace.span_seconds("ctc")
    return sum(spans) / run.tail["updates"] * 1e3 if spans else None
