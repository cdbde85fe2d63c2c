"""The engine's own host time per tick: the program's ``engine.tick``
spans less the ``engine.step`` spans inside them, over the ticks traced,
in ms."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None:
        return None
    ticks = p.seconds('engine.tick')
    if not ticks:
        return None
    return (sum(ticks) - sum(p.seconds('engine.step'))) / len(ticks) * 1e3
