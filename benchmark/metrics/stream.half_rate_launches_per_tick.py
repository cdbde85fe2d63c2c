"""Host kernel-launch calls made inside the program's ``encoder.half_rate``
spans per engine tick of the traced window: the launches of the
Squeezeformer's time reduction, its half-rate blocks and its recovery;
none on a program without that span."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None or not run.tail.get('ticks') \
            or not p.union('encoder.half_rate'):
        return None
    return p.launches_within('encoder.half_rate') / run.tail['ticks']
