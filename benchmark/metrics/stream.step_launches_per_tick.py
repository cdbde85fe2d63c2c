"""Host kernel-launch calls made inside the program's ``engine.step`` spans
per engine tick of the traced window; beside ``stream.launches_per_tick``
it says how many of a tick's launches are the model's and how many the
engine's own."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('ticks') or not p.union('engine.step'):
        return None
    return p.launches_within('engine.step') / run.tail['ticks']
