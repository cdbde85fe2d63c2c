"""Padded frames over frames fed to the encoder (batch rows × padded
length, the padding rows of the batch bucket included), from the shapes
seen at the call into the model, over the untraced part of the window,
in %."""


def read(run):
    h = run.head
    if not h.get("frames_fed"):
        return None
    return h["frames_padded"] / h["frames_fed"] * 100
