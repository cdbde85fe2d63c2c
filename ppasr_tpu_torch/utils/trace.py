"""Named host spans on the profiler's clock.

``span(name)`` opens ``torch.profiler.record_function('ppasr.' + name)``
while a ``torch.profiler`` session records. The profiler puts it in the
same timeline as the card's kernels, copies and sets, so a gap in the
card's work can be put down to the host work open at that time, with no
second clock to line up.

With no profiler recording, ``span`` returns one shared
``contextlib.nullcontext`` and costs one test of the profiler's state:
spans follow whoever starts a profiler (the trainer's
``train_conf.profile_steps``, a benchmark's traced run, an operator's own
session) and need no switch of their own. Counters are not kept here: they
stay plain attributes of the objects that do the work.

Spans sit at call sites (the streaming engine, the predictor, the train
step, the CTC loss), and inside a model's ``forward`` or ``forward_chunk``
only where a stage has no call of its own: the Squeezeformer's
``encoder.half_rate``, from its time reduction through its recovery.
``torch.export`` traces those models with no profiler recording, so the
span is the null context there and leaves nothing in the program.
"""
import contextlib

import torch

PREFIX = 'ppasr.'
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``'ppasr.' + name`` while a profiler
    records, and the shared null context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(PREFIX + name)
