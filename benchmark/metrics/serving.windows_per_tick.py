"""Stream windows served per engine tick: windows made ready by the PCM
the benchmark fed (counted by the chunk arithmetic from the samples of
each stream) over the engine's ``ticks``, in the untraced part of the
window. 1.0 means every tick serves one stream."""


def read(run):
    h = run.head
    if not h.get("ticks"):
        return None
    return h["windows"] / h["ticks"]
