"""The port's program spans (``ppasr_tpu_torch/utils/trace.py``) on the CPU,
with the tiny Conformer of ``tests/torch_tiny_artifact.write_zoo_artifact``,
each case once with no profiler recording (spans off) and once under a
``torch.profiler`` run (spans on):

- off: ``trace.span`` returns one shared null context and the engine's
  feeds or a ``predict_batch`` make no ``record_function`` call;
- on: the engine's run records ``ppasr.engine.step`` inside
  ``ppasr.engine.tick`` inside ``ppasr.engine.feed``, with the tick's other
  phases, one tick span per step counted in ``ticks``; ``predict_batch``
  records its phases for either frontend;
- either way the engine's ``windows`` grows by the slots each tick served
  (one call of the slot's decoder each), and ``predict_batch`` drops the
  uploaded waveforms before the encoder runs (they would add to its card
  memory peak).

The train step's spans are checked in the trainer's ``profile_steps`` trace
(tests/test_torch_trainer.py)."""
import weakref

import pytest
import torch

import ppasr_tpu_torch.predict as predict_mod
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.serving import StreamingBatchEngine
from ppasr_tpu_torch.utils import trace
from torch_tiny_artifact import speechlike, write_zoo_artifact

ENGINE = ('engine.feed', 'engine.lock', 'engine.featurize', 'engine.tick',
          'engine.assemble', 'engine.upload', 'engine.step', 'engine.select',
          'engine.fetch', 'engine.decode')
PREDICT = {'device': ('predict.waveform', 'predict.pad', 'predict.upload',
                      'predict.fbank', 'predict.encoder', 'predict.decode'),
           'host': ('predict.featurize', 'predict.pad', 'predict.upload',
                    'predict.encoder', 'predict.decode')}


@pytest.fixture(scope='module')
def predictors(tmp_path_factory):
    """The tiny streaming predictor by frontend, built once."""
    artifact = write_zoo_artifact(tmp_path_factory.mktemp('trace'),
                                  'conformer')
    return {f: PPASRPredictor(model_path=artifact, use_gpu=False,
                              use_device_frontend=f == 'device')
            for f in ('host', 'device')}


@pytest.fixture
def spans(request, monkeypatch):
    """Whether the test runs its work under a profiler (spans on), and the
    names of the ``record_function`` objects made meanwhile."""
    made = []
    real = torch.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    return request.param == 'on', made


def profiled(fn, on):
    """``fn()``'s result and the ``ppasr.`` host events recorded over it,
    (name without the prefix, start, end) in µs: under a CPU profiler when
    ``on``, else with no profiler and no events."""
    if not on:
        return fn(), []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name[len(trace.PREFIX):], e.time_range.start,
                  e.time_range.end) for e in prof.events()
                 if e.name.startswith(trace.PREFIX)]


def watch_waveforms(pred, monkeypatch):
    """A list that gets, at each encoder call, whether the waveforms last
    handed to the fbank are freed."""
    fbank, encode, seen, freed = (predict_mod.fbank_batch,
                                  pred.model.get_encoder_out, [], [])

    def watched_fbank(wavs, lens, **kw):
        seen.append(weakref.ref(wavs))
        return fbank(wavs, lens, **kw)

    def watched_encode(xs, lens):
        freed.append(seen[-1]() is None)
        return encode(xs, lens)
    monkeypatch.setattr(predict_mod, 'fbank_batch', watched_fbank)
    monkeypatch.setattr(pred.model, 'get_encoder_out', watched_encode)
    return freed


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize('spans', ['off', 'on'], indirect=True)
def test_engine_spans_and_windows(predictors, spans):
    on, made = spans
    if not on:
        assert trace.span('engine.feed') is trace.span('x') is trace._NULL
    made.clear()
    engine = StreamingBatchEngine(predictors['host'], max_streams=2)
    calls = []
    slots = [engine.open_stream() for _ in range(2)]
    for slot in slots:
        decoder = engine._decoders[slot]
        decode = decoder.decode_chunk
        decoder.decode_chunk = lambda probs, f=decode: (calls.append(1),
                                                        f(probs))[1]
    pcms = [speechlike(int(s * 16000), 40 + i)
            for i, s in enumerate((1.3, 0.9))]
    piece = 2560

    def feed_all():
        results = []
        for a in range(0, max(len(p) for p in pcms), piece):
            for slot, pcm in zip(slots, pcms):
                if a < len(pcm):
                    results.append(engine.feed(
                        slot, pcm[a:a + piece].tobytes(),
                        is_end=a + piece >= len(pcm)))
        return results
    results, events = profiled(feed_all, on)
    assert engine.ticks > 0 and engine.windows == len(calls) > 0
    assert engine.windows >= engine.ticks
    if not on:
        assert made == [] and trace.span('engine.feed') is trace._NULL
        return
    names = {n for n, _, _ in events}
    assert names == set(ENGINE)
    feeds = [e for e in events if e[0] == 'engine.feed']
    ticks = [e for e in events if e[0] == 'engine.tick']
    steps = [e for e in events if e[0] == 'engine.step']
    assert len(feeds) == len(results) and len(ticks) == engine.ticks
    assert len(steps) == len(ticks)
    for step in steps:
        tick = next(t for t in ticks if inside(step, t))
        assert any(inside(tick, f) for f in feeds)
    assert len(made) == len(events)


@pytest.mark.parametrize('spans', ['off', 'on'], indirect=True)
@pytest.mark.parametrize('frontend', ['device', 'host'])
def test_predict_batch_spans(predictors, spans, frontend, monkeypatch):
    on, made = spans
    pred = predictors[frontend]
    if frontend == 'device':
        freed = watch_waveforms(pred, monkeypatch)
    pcms = [speechlike(int(s * 16000), 50 + i)
            for i, s in enumerate((1.1, 0.6, 1.7))]
    made.clear()
    results, events = profiled(lambda: pred.predict_batch(pcms), on)
    assert len(results) == 3
    if frontend == 'device':
        assert freed == [True]
    if not on:
        assert made == [] and trace.span('predict.pad') is trace._NULL
        return
    assert sorted(n for n, _, _ in events) == sorted(PREDICT[frontend])
    order = [n for n, _, _ in sorted(events, key=lambda e: e[1])]
    assert order == list(PREDICT[frontend])
    assert len(made) == len(events)
