"""Port parity of the multi-stream engine: the JAX
``serving.StreamingBatchEngine`` and the port's, with ``max_streams=4``, on
the tiny artifact of tests/torch_tiny_artifact.py. Three streams are fed as
PCM bytes in 0.16 s pieces, interleaved and staggered (stream i opens once
stream i − 1 has fed two pieces: ``engine_texts`` of
tests/make_torch_smoke_fixture.py). Texts must be identical to JAX's, and
each stream's text equal to the port's single-stream host-frontend
``predict_stream`` of the same utterance. With a predictor built for
attention rescoring, each stream's final result is the rescoring pass
(texts identical, scores within 1e-4 absolute plus 1e-5 relative); in
bf16, texts equal or differing only at near ties
(tests/test_torch_bf16.py)."""
import os
import sys

import numpy as np
import pytest
import torch

import ppasr_tpu.decoders.greedy as jax_greedy
import ppasr_tpu.predict as jax_predict
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu.serving import StreamingBatchEngine as JaxEngine
import ppasr_tpu_torch.decoders.greedy as port_greedy
import ppasr_tpu_torch.predict as port_predict
from ppasr_tpu_torch.models.conformer_encoder import StreamingState
from ppasr_tpu_torch.models.streaming import stream_axes
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.serving import StreamingBatchEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402
from make_torch_smoke_fixture import engine_texts, stream_text  # noqa: E402
from torch_tiny_artifact import speechlike, write_artifact  # noqa: E402


@pytest.fixture(scope='module')
def predictors(tmp_path_factory):
    artifact = write_artifact(tmp_path_factory.mktemp('tiny_artifact'))
    return (JaxPredictor(model_path=artifact),
            PPASRPredictor(model_path=artifact, use_gpu=False))


@pytest.mark.parametrize('seed', [1, 2])
def test_staggered_streams_match_jax_and_single_stream(predictors, seed):
    jax_pred, port_pred = predictors
    rng = np.random.default_rng(seed)
    pcms = [speechlike(int(rng.uniform(1.5, 3.0) * 16000), seed * 10 + i)
            for i in range(3)]
    got = engine_texts(StreamingBatchEngine(port_pred, max_streams=4), pcms)
    want = engine_texts(JaxEngine(jax_pred, max_streams=4), pcms)
    assert got == want
    assert all(len(t) > 5 for t in want)
    assert got == [stream_text(port_pred, p) for p in pcms]


@pytest.mark.parametrize('mode', ['attention_rescoring', 'bfloat16'])
def test_engine_rescoring_and_bf16_match_jax(tmp_path, mode):
    artifact = write_artifact(tmp_path)
    opts = dict(decoder='attention_rescoring', decoder_configs=dict(
        beam_size=16, cutoff_top_n=12, cutoff_prob=0.99, alpha=0.3,
        beta=1.5, max_hyp_len=64)) if mode == 'attention_rescoring' else dict(
        compute_dtype='bfloat16')
    jax_pred = JaxPredictor(model_path=artifact, **opts)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False, **opts)
    rng = np.random.default_rng(3)
    pcms = [speechlike(int(rng.uniform(1.5, 3.0) * 16000), 30 + i)
            for i in range(3)]
    if mode == 'attention_rescoring':
        results = fx.engine_results(StreamingBatchEngine(port_pred, 4),
                                    pcms)
        want = fx.engine_results(JaxEngine(jax_pred, 4), pcms)
        got = [r['text'] for r in results]
        assert got == [r['text'] for r in want]
        np.testing.assert_allclose([r['score'] for r in results],
                                   [r['score'] for r in want], rtol=1e-5,
                                   atol=1e-4)
    else:
        got, bad = fx.texts_under_near_ties(
            lambda: engine_texts(JaxEngine(jax_pred, 4), pcms),
            (jax_predict, jax_greedy),
            lambda: engine_texts(StreamingBatchEngine(port_pred, 4), pcms),
            (port_predict, port_greedy))
        assert not bad
    assert all(len(t) > 5 for t in got)


def test_slots_capacity_and_closed_slot(predictors):
    engine = StreamingBatchEngine(predictors[1], max_streams=2)
    slots = [engine.open_stream(), engine.open_stream()]
    assert sorted(slots) == [0, 1]
    assert engine.open_stream() is None
    engine.close_stream(slots[0])
    with pytest.raises(KeyError):
        engine.feed(slots[0], np.zeros(2560, np.float32))
    assert engine.open_stream() == slots[0]


def test_stream_axes_name_the_layout():
    """Each family's state names its stream axes (the JAX engine's, field
    by field); any other state raises TypeError, as in JAX."""
    from ppasr_tpu_torch.models.deepspeech2 import DS2State
    from ppasr_tpu_torch.models.efficient_conformer import EffConState
    from ppasr_tpu_torch.models.squeezeformer import SqueezeformerState
    z = torch.zeros(1)
    state = StreamingState(*(z for _ in range(5)))
    assert state.stream_axes() == (0, 0, 1, 1, 1)
    assert stream_axes(state) == (0, 0, 1, 1, 1)
    assert DS2State(z, z).stream_axes() == (1, 1)
    for cls in (SqueezeformerState, EffConState):
        axes = stream_axes(cls(z, z, (z, z, z), (z, z, z), (z, z, z)))
        assert type(axes) is cls
        assert axes == (0, 0, (0, 0, 0), (0, 0, 0), (0, 0, 0))
    with pytest.raises(TypeError, match='unknown state type'):
        stream_axes((torch.zeros(1), torch.zeros(1)))
