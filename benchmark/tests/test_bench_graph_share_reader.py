"""The reader of ``train.graph_share`` on hand-made profiler events
(``test_bench_program_spans``' helpers): None without a trace and None
where the program opens no ``train.graph`` span (a parent's run, a step
that runs every micro-step eagerly); else the count of ``train.graph``
spans over the count of ``train.forward`` spans, in %, only those that
start inside the ``bench.trace`` window counting."""
from types import SimpleNamespace

import pytest

from harness import spec
from test_bench_program_spans import CPU, CUDA, Event, traced


def train_events(replayed=3):
    """A window of 1000 ns with four micro-steps' ``train.forward`` spans,
    the last ``replayed`` of them each holding a ``train.graph`` span, and
    one more replayed micro-step that starts after the window."""
    ev = [Event('bench.trace', CPU, 0, 1000),
          Event('gemm', CUDA, 150, 250)]
    for i in range(4):
        a = 100 + 200 * i
        ev.append(Event('ppasr.train.forward', CPU, a, a + 100))
        if i >= 4 - replayed:
            ev.append(Event('ppasr.train.graph', CPU, a + 50, a + 60))
    ev += [Event('ppasr.train.forward', CPU, 1100, 1200),
           Event('ppasr.train.graph', CPU, 1150, 1160)]
    return ev


@pytest.mark.parametrize('replayed, want', [(4, 100.0), (3, 75.0),
                                            (0, None)])
def test_graph_share_reader(replayed, want):
    read = spec.metric_reader('train.graph_share')
    assert read(SimpleNamespace(trace=None, tail={'updates': 1})) is None
    value = read(SimpleNamespace(trace=traced(train_events(replayed)),
                                 tail={'updates': 1}))
    assert value == (None if want is None else pytest.approx(want))
