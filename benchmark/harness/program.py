"""The program's own spans in the traced tail of a ``--trace 1`` run.

While the profiler records, ``ppasr_tpu_torch/utils/trace.py`` opens
``ppasr.<name>`` host spans around the program's phases (the engine's tick,
``predict_batch``'s steps, the train step's). They lie in the profile that
``Tracer`` keeps after its ``stop()``, on the clock of the card's
operations. ``of(tracer)`` reads them once per run, with the host's
kernel-launch calls, keeping what starts inside the ``bench.trace`` window
as ``Tracer`` does; ``Tracer.gaps`` gives the card's idle gaps.

A program without such spans gives an empty reading, so each metric that
reads one returns None there and raises nothing."""
import bisect
import weakref
from collections import defaultdict

import torch

PREFIX = 'ppasr.'
LAUNCHES = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
            'cuLaunchKernelEx')
_READ = weakref.WeakKeyDictionary()


class ProgramSpans:
    def __init__(self, events, gaps):
        cuda = torch.autograd.DeviceType.CUDA
        spans, launches, window = [], [], None
        for e in events:
            if e.device_type() == cuda:
                continue
            name, a = e.name(), e.start_ns()
            if name == 'bench.trace':
                window = (a, a + e.duration_ns())
            elif name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], a, a + e.duration_ns()))
            elif name in LAUNCHES:
                launches.append(a)
        lo, hi = window if window is not None else (0, -1)
        self.spans = sorted((s for s in spans if lo <= s[1] < hi),
                            key=lambda s: s[1])
        self.launches = sorted(t for t in launches if lo <= t < hi)
        self.gaps = gaps

    def seconds(self, *names):
        """Durations of the spans of these names, in s."""
        return [(b - a) / 1e9 for n, a, b in self.spans if n in names]

    def union(self, name):
        """The union of the spans of that name, at any depth: sorted
        [start, end) ns intervals."""
        out = []
        for n, a, b in self.spans:
            if n != name:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def idle_within(self, name: str) -> float:
        """Device-idle seconds inside the spans of that name."""
        total, gaps = 0, self.gaps
        starts = [g[0] for g in gaps]
        for a, b in self.union(name):
            for g0, g1 in gaps[max(0, bisect.bisect_right(starts, a) - 1):
                               bisect.bisect_left(starts, b)]:
                total += max(0, min(b, g1) - max(a, g0))
        return total / 1e9

    def launches_within(self, name: str) -> int:
        """Host kernel-launch calls that start inside the spans of that name
        (any thread: autograd's device thread while ``train.backward`` is
        open counts)."""
        return sum(bisect.bisect_left(self.launches, b)
                   - bisect.bisect_left(self.launches, a)
                   for a, b in self.union(name))

    def idle_gaps(self, bench_spans, top: int = 12):
        """Idle device time summed by the innermost span open at each gap's
        middle, of the program's spans and the benchmark's
        (``Tracer.spans``) together; spans of one thread nest."""
        spans = sorted(list(bench_spans) + self.spans, key=lambda s: s[1])
        by, stack, i = defaultdict(int), [], 0
        for g0, g1 in sorted(self.gaps):
            mid = (g0 + g1) // 2
            while i < len(spans) and spans[i][1] <= mid:
                while stack and stack[-1][2] <= spans[i][1]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][2] <= mid:
                stack.pop()
            by[stack[-1][0] if stack else 'idle'] += g1 - g0
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def of(tracer):
    """The program's spans in a traced run's profile, or None where the run
    was not traced."""
    if tracer is None or getattr(tracer, '_prof', None) is None:
        return None
    if tracer not in _READ:
        _READ[tracer] = ProgramSpans(
            tracer._prof.profiler.kineto_results.events(), tracer.gaps)
    return _READ[tracer]
