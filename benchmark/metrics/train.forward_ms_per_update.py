"""Host time of the program's ``train.frontend`` + ``train.forward`` spans (B1
with the dither and the augmentations, and the training forward with its
losses) per update of the traced window, in ms."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('updates'):
        return None
    spans = p.seconds('train.frontend', 'train.forward')
    return sum(spans) / run.tail['updates'] * 1e3 if spans else None
