"""Host kernel-launch calls made while the program's ``train.backward``
spans are open (autograd's device thread included) per update of the
traced window; beside ``train.launches_per_update`` it says what share of
an update's launches the backward issues."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('updates') \
            or not p.union('train.backward'):
        return None
    return p.launches_within('train.backward') / run.tail['updates']
