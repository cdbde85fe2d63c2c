"""Host time of the program's ``train.backward`` spans (autograd's backward,
its device thread included) per update of the traced window, in ms."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('updates'):
        return None
    spans = p.seconds('train.backward')
    return sum(spans) / run.tail['updates'] * 1e3 if spans else None
