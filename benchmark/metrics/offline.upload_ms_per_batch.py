"""Host time of the program's ``predict.upload`` spans (the padded batch's
copy to the card) per batch of the traced window, in ms."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('batches'):
        return None
    spans = p.seconds('predict.upload')
    return sum(spans) / run.tail['batches'] * 1e3 if spans else None
