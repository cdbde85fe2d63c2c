"""Share of the traced window's micro-steps whose training forward replayed
a CUDA graph: the count of the program's ``train.graph`` spans (one around
each forward graph's replay, inside ``train.forward``) over the count of
its ``train.forward`` spans, in %; none on a program without
``train.forward`` spans or without ``train.graph`` spans (one that runs
every micro-step eagerly)."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None:
        return None
    forwards, graphs = p.seconds('train.forward'), p.seconds('train.graph')
    if not forwards or not graphs:
        return None
    return len(graphs) / len(forwards) * 100
