"""Host time of the program's ``train.optimizer`` spans (the division by
accum_grad, the clip, AdamW and zero_grad) per update of the traced window,
in ms."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('updates'):
        return None
    spans = p.seconds('train.optimizer')
    return sum(spans) / run.tail['updates'] * 1e3 if spans else None
