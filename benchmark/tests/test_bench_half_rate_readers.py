"""The readers of ``stream.half_rate_share`` and
``stream.half_rate_launches_per_tick`` on hand-made profiler events
(``test_bench_program_spans``' helpers): each returns None without a trace,
and None where the program has no ``encoder.half_rate`` span (a parent's
run, another family), and the share or count the events give otherwise."""
from types import SimpleNamespace

import pytest

from harness import program, spec
from test_bench_program_spans import CPU, CUDA, Event, traced


def stream_events(half=True):
    """A window of 1000 ns: two ``engine.step`` spans of 200 and 300 ns,
    each holding an ``encoder.half_rate`` span of 50 and 150 ns; launch
    calls at 120 and 130 (the first half-rate span), 170 (outside it),
    420 (the second)."""
    ev = [Event('bench.trace', CPU, 0, 1000),
          Event('ppasr.engine.step', CPU, 100, 300),
          Event('ppasr.engine.step', CPU, 400, 700),
          Event('cudaLaunchKernel', CPU, 120, 121),
          Event('cudaLaunchKernel', CPU, 130, 131),
          Event('cudaLaunchKernel', CPU, 170, 171),
          Event('cudaLaunchKernel', CPU, 420, 421),
          Event('gemm', CUDA, 150, 250)]
    if half:
        ev += [Event('ppasr.encoder.half_rate', CPU, 110, 160),
               Event('ppasr.encoder.half_rate', CPU, 410, 560)]
    return ev


@pytest.mark.parametrize('name, want', [
    ('stream.half_rate_share', 40.0),
    ('stream.half_rate_launches_per_tick', 1.5)])
def test_half_rate_readers(name, want):
    read = spec.metric_reader(name)
    assert read(SimpleNamespace(trace=None, tail={'ticks': 2})) is None
    no_span = traced(stream_events(half=False))
    assert read(SimpleNamespace(trace=no_span, tail={'ticks': 2})) is None
    assert program.of(traced(stream_events())) is not None
    value = read(SimpleNamespace(trace=traced(stream_events()),
                                 tail={'ticks': 2}))
    assert value == pytest.approx(want)

