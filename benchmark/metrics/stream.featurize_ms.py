"""Mean host time of one call into the stream featurizer (the host
log-mel of a piece), from the benchmark's ``featurize`` spans in the
trace, in ms."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.span_seconds("featurize")
    return sum(s) / len(s) * 1e3 if s else None
