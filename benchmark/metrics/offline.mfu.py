"""Encoder and CTC-head FLOPs of the valid frames of every utterance
transcribed (``flops/<config>.py``) over the untraced part of the window
and the fp32 peak, in %."""


def read(run):
    h = run.head
    if run.peaks is None or not h.get("flops") or not h.get("seconds"):
        return None
    return h["flops"] / (h["seconds"] * run.peaks["fp32_flops"]) * 100
