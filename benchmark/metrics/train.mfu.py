"""Three times the forward FLOPs of every completed update's valid frames
and tokens (``flops/<config>.py``: encoder, CTC head, both decoders) over
the untraced part of the window and the fp32 peak, in %."""


def read(run):
    h = run.head
    if run.peaks is None or not h.get("flops") or not h.get("seconds"):
        return None
    return h["flops"] / (h["seconds"] * run.peaks["fp32_flops"]) * 100
