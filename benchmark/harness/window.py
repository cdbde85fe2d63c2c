"""The measured window, the same for every kind of traffic.

``Window.run(advance)`` opens the window (set-up ends there), calls
``advance(now)`` with the seconds since it opened until ``advance`` returns
false, waits for the card, and closes it. In a ``--trace 1`` run the
profiler starts ``trace_seconds`` before ``--seconds``: the counters
(``counters()``, numbers only) are read at the open, at the profiler's
start and at the close, so ``head`` holds their growth over the untraced
part of the window (and ``seconds``, its length) and ``tail`` over the
traced part."""
import math
import time

from harness.check import sync


class Window:
    def __init__(self, ctx, trace_seconds: float, counters):
        self.ctx, self.counters = ctx, counters
        self.trace_at = ctx.seconds - float(trace_seconds) \
            if ctx.tracer.enabled else math.inf
        self.t0 = None
        self.seconds = 0.0
        self.head = self.tail = None

    def clock(self) -> float:
        return time.perf_counter() - self.t0

    def run(self, advance):
        ctx, tracer = self.ctx, self.ctx.tracer
        marks = {}

        def mark(name, t):
            marks[name] = dict(self.counters(), seconds=t)

        tracer.warm()
        self.t0 = time.perf_counter()
        ctx.window_opened()
        mark('start', 0.0)
        while True:
            now = self.clock()
            if now >= self.trace_at and 'trace' not in marks:
                mark('trace', now)
                tracer.start()
            if not advance(now):
                break
        sync(ctx.device)
        self.seconds = self.clock()
        tracer.stop()
        mark('end', self.seconds)
        ctx.window_closed()
        start, end = marks['start'], marks['end']
        cut = marks.get('trace', end)
        self.head = {k: cut[k] - start[k] for k in start}
        self.tail = {k: end[k] - cut[k] for k in start}
        return self
