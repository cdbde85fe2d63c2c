"""Share of the host time of the program's ``engine.step`` spans spent
inside its ``encoder.half_rate`` spans (the Squeezeformer's time
reduction, the blocks at half the frame rate and the recovery's residual
add) in the traced window, in %; none on a program without that span."""
from harness import program


def read(run):
    p = program.of(run.trace)
    if p is None:
        return None
    step, half = p.seconds('engine.step'), p.seconds('encoder.half_rate')
    if not step or not half:
        return None
    return sum(half) / sum(step) * 100
