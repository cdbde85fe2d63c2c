"""Share of the traced window in which the card idled while the program's
``engine.step`` span was open (the engine issuing the model's chunk call;
in this cell the span also holds the harness's capture copy), in %."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or run.trace.window_s <= 0 or not p.union('engine.step'):
        return None
    return p.idle_within('engine.step') / run.trace.window_s * 100
