"""Chunk-step FLOPs of the stream windows served (``flops/<config>.py``:
valid frames and the valid cache keys only) over the untraced part of the
window and the fp32 peak, in %."""


def read(run):
    h = run.head
    if run.peaks is None or not h.get("flops") or not h.get("seconds"):
        return None
    return h["flops"] / (h["seconds"] * run.peaks["fp32_flops"]) * 100
