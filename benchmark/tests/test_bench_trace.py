"""The trace reader on hand-made profiler events: the union of device
intervals, the gaps named by the innermost host span, and the card's
copies of host annotations left out of the device operations."""
import pytest
import torch

from harness.trace import Tracer

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


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


def test_busy_gaps_and_annotations():
    events = [
        Event('bench.trace', CPU, 0, 1000),
        Event('bench.feed', CPU, 100, 900),
        Event('bench.chunk_step', CPU, 150, 400),
        Event('Optimizer.step#AdamW.step', CPU, 500, 600),
        Event('Optimizer.step#AdamW.step', CUDA, 500, 990),
        Event('gemm', CUDA, 200, 300),
        Event('gemm', CUDA, 250, 350),        # overlaps the first
        Event('Memcpy DtoH', CUDA, 700, 800),
    ]
    t = Tracer(True)
    t._read(events)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(250e-9)
    assert t.kernel_count() == 2
    assert [n for n, _ in t.device_ops()] == ['gemm', 'Memcpy DtoH']
    gaps = dict(t.idle_gaps())
    # [0, 200) mid 100: feed opens at 100; [350, 700) mid 525: feed;
    # [800, 1000) mid 900: nothing open
    assert gaps['feed'] == pytest.approx(550e-9)
    assert gaps['idle'] == pytest.approx(200e-9)
    assert t.span_seconds('chunk_step') == [pytest.approx(250e-9)]
