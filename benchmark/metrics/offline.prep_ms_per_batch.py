"""Host time of the program's ``predict.waveform`` + ``predict.pad`` spans
(the host's load, gain and int16 rounding of each utterance and the padded
numpy batch) per batch of the traced window, in ms."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('batches'):
        return None
    spans = p.seconds('predict.waveform', 'predict.pad')
    return sum(spans) / run.tail['batches'] * 1e3 if spans else None
