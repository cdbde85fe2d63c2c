"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CPU and CUDA
activity) over the last ``trace_seconds`` of the window, and the
benchmark's own host spans (``span``), opened around the calls into each
layer of the program.

From the profiler's events it keeps, in the traced window: each device
operation (kernels, copies, sets) as (name, start, end), each ``bench.*``
span as (name, start, end), the union of the device intervals (``busy_s``)
and the window's length (``window_s``, the ``bench.trace`` span around
it). Idle gaps between device intervals are named by the innermost
benchmark span open at the gap's middle (``idle`` where none is)."""
import bisect
import contextlib
from collections import defaultdict

import torch

DEVICE_ACTIVITIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


def device_ops(events):
    """(name, start ns, end ns) of each kernel, copy or set on the card.
    The card's copies of host annotations (``bench.*``, the optimizer's
    step) are left out: by ``activity_type`` where PyTorch has it, else by
    a name that a host event also bears."""
    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name() for e in events if e.device_type() != cuda}
    out = []
    for e in events:
        if e.device_type() != cuda:
            continue
        activity = getattr(e, 'activity_type', None)
        if (activity() in DEVICE_ACTIVITIES if activity is not None
                else e.name() not in host):
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self._prof = self._window = None
        self.ops, self.spans = [], []
        self.window_s = self.busy_s = 0.0
        self.gaps = []

    def span(self, name: str):
        """A host span around a call into the program, recorded while the
        profiler runs (a no-op otherwise)."""
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function('bench.' + name)

    def warm(self):
        """One short profiling session in set-up: the profiler's first
        start on the card takes seconds, which must not fall in the
        window."""
        if not self.enabled:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities):
            torch.ones(8, device='cuda' if torch.cuda.is_available()
                       else 'cpu').sum().item()

    def start(self):
        if not self.enabled or self.active or self._prof is not None:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self._window = torch.profiler.record_function('bench.trace')
        self._window.__enter__()
        self.active = True

    def stop(self):
        if not self.active:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        self._read(self._prof.profiler.kineto_results.events())

    def _read(self, events):
        spans, window = [], None
        ops = device_ops(events)
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                continue
            if name == 'bench.trace':
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name.startswith('bench.'):
                spans.append((name[6:], e.start_ns(),
                              e.start_ns() + e.duration_ns()))
        if window is None:
            raise RuntimeError("the profiler recorded no bench.trace span")
        lo, hi = window
        self.window_s = (hi - lo) / 1e9
        self.ops = sorted((o for o in ops if lo <= o[1] < hi),
                          key=lambda o: o[1])
        self.spans = sorted((s for s in spans if lo <= s[1] < hi),
                            key=lambda s: s[1])
        busy, gaps, end = 0, [], lo
        for _, a, b in self.ops:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if hi > end:
            gaps.append((end, hi))
        self.busy_s = busy / 1e9
        self.gaps = gaps

    # ------------------------------------------------------------ readings

    def span_seconds(self, name: str):
        return [(b - a) / 1e9 for n, a, b in self.spans if n == name]

    def op_seconds(self, match: str):
        return [(b - a) / 1e9 for n, a, b in self.ops if match in n]

    def kernel_count(self) -> int:
        return sum(1 for n, a, b in self.ops if not n.startswith('Memcpy')
                   and not n.startswith('Memset'))

    def device_ops(self, top: int = 10):
        by = defaultdict(int)
        for n, a, b in self.ops:
            by[n] += b - a
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """Idle device time summed by the innermost span open at each gap's
        middle."""
        starts = [s[1] for s in self.spans]
        by = defaultdict(int)
        for a, b in self.gaps:
            mid = (a + b) // 2
            name = 'idle'
            i = bisect.bisect_right(starts, mid)
            best = None
            for n, s0, s1 in reversed(self.spans[max(0, i - 64):i]):
                if s0 <= mid < s1 and (best is None or s0 > best[0]):
                    best = (s0, n)
            if best is not None:
                name = best[1]
            by[name] += b - a
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]
