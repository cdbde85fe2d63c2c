"""The Squeezeformer's program span and the engine's state counter on the
CPU, with tiny models written by the port alone (no JAX):

- ``encoder.half_rate`` (``models/squeezeformer.py``) is recorded once per
  chunk step, inside the engine's ``engine.step``, and once per offline
  forward while a ``torch.profiler`` session records; with none recording
  the encoder makes no ``record_function`` call and the span is the shared
  null context;
- ``StreamingBatchEngine.state_bytes`` is the size of the batched state
  over every leaf, for the Squeezeformer (2 + 3 per block leaves) and the
  Conformer (5)."""
import json

import numpy as np
import pytest
import torch

from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.models.streaming import tree_leaves
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.serving import StreamingBatchEngine
from ppasr_tpu_torch.utils import trace
from ppasr_tpu_torch.utils.checkpoint import export_params, save_msgpack

VOCAB = ['<blank>', '<unk>'] + [chr(0x4E00 + i) for i in range(12)] \
    + ['<eos>']
ENC = {'squeezeformer': dict(encoder_dim=16, output_size=16,
                             attention_heads=2, num_blocks=4, reduce_idx=1,
                             recover_idx=3, feed_forward_expansion_factor=2,
                             cnn_module_kernel=3),
       'conformer': dict(output_size=16, attention_heads=2, linear_units=32,
                         num_blocks=2, cnn_module_kernel=3)}
DEC = dict(attention_heads=2, linear_units=16, num_blocks=1, r_num_blocks=0)


def write_artifact(out, use_model):
    (out / 'vocabulary.txt').write_text(
        ''.join(f'{v}\t-1\n' for v in VOCAB), encoding='utf-8')
    (out / 'mean_istd.json').write_text(json.dumps(
        {'mean': [0.0] * 80, 'istd': [0.25] * 80}), encoding='utf-8')
    conf = {'use_model': use_model, 'streaming': True, 'input_dim': 80,
            'vocab_size': len(VOCAB), 'encoder_conf': ENC[use_model],
            'decoder_conf': DEC, 'model_conf': {'ctc_weight': 0.3}}
    (out / 'inference.json').write_text(json.dumps(conf), encoding='utf-8')
    torch.manual_seed(3)
    model = build_model(use_model, 80, len(VOCAB), True, ENC[use_model], DEC,
                        {'ctc_weight': 0.3})
    save_msgpack(str(out / 'model.msgpack'), export_params(model))
    return str(out)


@pytest.fixture(scope='module')
def predictors(tmp_path_factory):
    torch.set_num_threads(1)
    return {m: PPASRPredictor(
        model_path=write_artifact(tmp_path_factory.mktemp(m), m),
        use_gpu=False, decoding_chunk_size=16, num_decoding_left_chunks=2)
        for m in ENC}


@pytest.fixture
def made(monkeypatch):
    """The names of the ``record_function`` objects made while it lives."""
    names = []
    real = torch.profiler.record_function

    def counted(name, *args):
        names.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    return names


def profiled(fn, on):
    """``fn()``'s result and its ``ppasr.`` events (name, start, end)."""
    if not on:
        return fn(), []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name[len(trace.PREFIX):], e.time_range.start,
                  e.time_range.end) for e in prof.events()
                 if e.name.startswith(trace.PREFIX)]


def pcm(seconds, seed):
    rng = np.random.default_rng(seed)
    return np.round(rng.normal(0, 2000, int(seconds * 16000))).astype(
        np.int16)


@pytest.mark.parametrize('on', [False, True])
def test_half_rate_span_per_chunk_step(predictors, made, on):
    engine = StreamingBatchEngine(predictors['squeezeformer'], max_streams=2)
    slots = [engine.open_stream() for _ in range(2)]
    pcms = [pcm(1.1, 1), pcm(0.7, 2)]

    def feed_all():
        for a in range(0, len(pcms[0]), 2560):
            for slot, p in zip(slots, pcms):
                if a < len(p):
                    engine.feed(slot, p[a:a + 2560].tobytes(),
                                is_end=a + 2560 >= len(p))
    made.clear()
    _, events = profiled(feed_all, on)
    assert engine.ticks > 1
    if not on:
        assert made == [] and trace.span('encoder.half_rate') is trace._NULL
        return
    half = [e for e in events if e[0] == 'encoder.half_rate']
    steps = [e for e in events if e[0] == 'engine.step']
    assert len(half) == len(steps) == engine.ticks
    for h, s in zip(sorted(half), sorted(steps)):
        assert s[1] <= h[1] and h[2] <= s[2]


@pytest.mark.parametrize('on', [False, True])
def test_half_rate_span_per_offline_forward(predictors, made, on):
    model = predictors['squeezeformer'].model
    xs = torch.randn(2, 131, 80)
    made.clear()
    with torch.no_grad():
        (out, _), events = profiled(
            lambda: model.get_encoder_out(xs, torch.tensor([131, 77])), on)
    assert out.shape[:2] == (2, 32)
    assert [e[0] for e in events] == (['encoder.half_rate'] if on else [])
    assert made == (['ppasr.encoder.half_rate'] if on else [])


@pytest.mark.parametrize('use_model, leaves', [('squeezeformer', 2 + 3 * 4),
                                               ('conformer', 5)])
def test_state_bytes_counts_every_leaf(predictors, use_model, leaves):
    pred = predictors[use_model]
    engine = StreamingBatchEngine(pred, max_streams=3)
    state = pred.model.init_state(3, pred.cache_size, pred.device)
    parts = tree_leaves(state)
    assert len(parts) == leaves
    assert engine.state_bytes == sum(x.numel() * x.element_size()
                                     for x in parts) > 0
    assert engine.state_bytes == sum(x.numel() * x.element_size() for x in
                                     tree_leaves(engine._batch_state))
