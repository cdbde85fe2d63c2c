"""Audio seconds of every utterance ``predict_batch`` returned in the
untraced part of the window over that part's wall time."""


def read(run):
    h = run.head
    if not h.get("audio_s") or not h.get("seconds"):
        return None
    return h["audio_s"] / h["seconds"]
