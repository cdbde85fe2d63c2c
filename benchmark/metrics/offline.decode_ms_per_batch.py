"""Host time of the program's ``predict.decode`` spans (the argmax, the copy
to the host and the collapse) per batch of the traced window, in ms."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('batches'):
        return None
    spans = p.seconds('predict.decode')
    return sum(spans) / run.tail['batches'] * 1e3 if spans else None
