"""The program's spans (``harness/program.py``) on hand-made profiler
events: a ``ppasr.`` span inside a ``bench.`` span names the idle gap at
its middle, ``idle_within`` and ``launches_within`` count overlap and
host launch calls over the union of a name's spans, only what starts in
the ``bench.trace`` window counts, and every reader of a program span
returns None without a trace or without program spans (a parent's run)
and a number with them."""
from types import SimpleNamespace

import pytest
import torch

from harness import program, spec
from harness.trace import Tracer

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

READERS = {
    'device.idle_in_step.stream': 'ticks',
    'stream.step_launches_per_tick': 'ticks',
    'serving.engine_ms_per_tick': 'ticks',
    'offline.prep_ms_per_batch': 'batches',
    'offline.upload_ms_per_batch': 'batches',
    'offline.decode_ms_per_batch': 'batches',
    'train.forward_ms_per_update': 'updates',
    'train.backward_ms_per_update': 'updates',
    'train.optimizer_ms_per_update': 'updates',
    'train.backward_launches_per_update': 'updates',
}


class Event:
    def __init__(self, name, device, start, end):
        self._v = name, device, start, end - start

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def traced(events):
    """A stopped ``Tracer`` that read ``events``, as the run leaves it."""
    t = Tracer(True)
    t._read(events)
    t._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return t


def program_events():
    """One traced window of 1000 ns: a bench span holding two program
    spans of one name and one of another; kernels at [200, 300) and
    [700, 800); launch calls at 120, 150, 450 (in the two spans), 600 and
    the window's 50 (outside them); spans and launches before the window
    left out."""
    return [
        Event('ppasr.engine.step', CPU, -300, -100),  # before the window
        Event('cudaLaunchKernel', CPU, -200, -190),
        Event('bench.trace', CPU, 0, 1000),
        Event('cudaLaunchKernel', CPU, 50, 55),
        Event('bench.feed', CPU, 100, 900),
        Event('ppasr.engine.step', CPU, 110, 250),
        Event('cudaLaunchKernel', CPU, 120, 125),
        Event('cuLaunchKernelEx', CPU, 150, 155),
        Event('ppasr.engine.step', CPU, 240, 500),    # overlaps the first
        Event('cudaLaunchKernelExC', CPU, 450, 455),
        Event('ppasr.engine.fetch', CPU, 550, 650),
        Event('cudaLaunchKernel', CPU, 600, 605),
        Event('gemm', CUDA, 200, 300),
        Event('Memcpy DtoH', CUDA, 700, 800),
    ]


@pytest.mark.parametrize('case', ['gaps', 'idle_within', 'launches_within',
                                  'window'])
def test_program_spans(case):
    t = traced(program_events())
    p = program.of(t)
    assert program.of(t) is p                      # read once per run
    if case == 'gaps':
        # [0, 200) mid 100: feed opens at 100, step at 110; [300, 700) mid
        # 500: the step ends at 500, so feed; [800, 1000) mid 900: none
        gaps = dict(p.idle_gaps(t.spans))
        assert gaps == {'feed': pytest.approx(600e-9),
                        'idle': pytest.approx(200e-9)}
        # the fetch span holds the middle of a gap of its own
        t2 = traced(program_events() + [Event('gemm', CUDA, 300, 560)])
        gaps = dict(program.of(t2).idle_gaps(t2.spans))
        assert gaps['engine.fetch'] == pytest.approx(140e-9)
    elif case == 'idle_within':
        # the steps' union [110, 500): idle [110, 200) and [300, 500)
        assert p.idle_within('engine.step') == pytest.approx(290e-9)
        assert p.idle_within('engine.fetch') == pytest.approx(100e-9)
        assert p.idle_within('engine.tick') == 0
    elif case == 'launches_within':
        assert p.launches_within('engine.step') == 3
        assert p.launches_within('engine.fetch') == 1
        assert len(p.launches) == 5
    else:
        assert p.union('engine.step') == [[110, 500]]
        assert p.seconds('engine.step', 'engine.fetch') == [
            pytest.approx(140e-9), pytest.approx(260e-9),
            pytest.approx(100e-9)]


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_needs_program_spans(name):
    read = spec.metric_reader(name)
    per = READERS[name]
    assert read(SimpleNamespace(trace=None, tail={per: 2})) is None
    assert program.of(None) is None
    bench_only = [e for e in program_events()
                  if not e.name().startswith(program.PREFIX)]
    assert read(SimpleNamespace(trace=traced(bench_only),
                                tail={per: 2})) is None
    spans = [e for e in program_events() if e.name() != 'ppasr.engine.step']
    ends = {'ticks': [('engine.tick', 100, 600), ('engine.step', 110, 500)],
            'batches': [('predict.waveform', 100, 300),
                        ('predict.pad', 300, 350),
                        ('predict.upload', 350, 400),
                        ('predict.decode', 400, 450)],
            'updates': [('train.frontend', 100, 150),
                        ('train.forward', 150, 300),
                        ('train.backward', 300, 600),
                        ('train.optimizer', 600, 650)]}[per]
    spans += [Event(program.PREFIX + n, CPU, a, b) for n, a, b in ends]
    value = read(SimpleNamespace(trace=traced(spans), tail={per: 2}))
    assert isinstance(value, float | int) and value >= 0
