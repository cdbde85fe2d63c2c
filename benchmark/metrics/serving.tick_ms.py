"""Mean host time of one engine tick (a batched chunk step over every
slot, the posteriors back on the host): the engine's own counters
``tick_seconds`` / ``ticks`` over the untraced part of the window, in ms."""


def read(run):
    h = run.head
    if not h.get("ticks"):
        return None
    return h["tick_seconds"] / h["ticks"] * 1e3
