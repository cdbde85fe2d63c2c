"""Port parity of attention rescoring on the CPU: ``PPASRPredictor(decoder=
'attention_rescoring')`` of the JAX package and of the port on the tiny
artifact of tests/torch_tiny_artifact.py (its decoder: 1 + 1 blocks,
``reverse_weight`` 0.3, ``ctc_weight`` 0.3), with the same beam options,
through ``predict``, ``predict_batch`` and ``predict_stream`` on both
frontends and through the multi-stream engine. Texts must be identical and
scores within 1e-4 absolute plus 1e-5 relative (the beam's CTC scores and
the decoder's float32 log-probs, summed in other orders).

Also: the rescorer's options (``rescore_ctc_weight``, ``max_hyp_len``), a
rescorer that cannot be built raises, the streamed partial results stay
greedy, ``reset_stream`` clears the kept chunks, and the predictor loads
every leaf of the artifact, the decoder's too."""
import os
import sys

import numpy as np
import pytest
import torch

from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu.serving import StreamingBatchEngine as JaxEngine
from ppasr_tpu_torch.decoders.rescoring import AttentionRescoringDecoder
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.serving import StreamingBatchEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_torch_smoke_fixture import engine_results  # noqa: E402
from torch_tiny_artifact import speechlike, write_artifact  # noqa: E402

# hypotheses of up to 64 tokens (the default 200 runs in
# tests/test_torch_flagship.py): the tiny model's texts are shorter
CONF = dict(beam_size=24, cutoff_top_n=12, cutoff_prob=0.99, alpha=0.3,
            beta=1.5, max_hyp_len=64)


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    return write_artifact(tmp_path_factory.mktemp('tiny_artifact'))


@pytest.fixture(scope='module')
def predictors(artifact):
    return {device: (
        JaxPredictor(model_path=artifact, use_device_frontend=device,
                     decoder='attention_rescoring', decoder_configs=CONF),
        PPASRPredictor(model_path=artifact, use_gpu=False,
                       use_device_frontend=device,
                       decoder='attention_rescoring', decoder_configs=CONF))
        for device in (False, True)}


def _same(got, want):
    assert [r['text'] for r in got] == [r['text'] for r in want]
    np.testing.assert_allclose([r['score'] for r in got],
                               [r['score'] for r in want], rtol=1e-5,
                               atol=1e-4)


def _stream(pred, pcm, piece=2560):
    pred.reset_stream()
    return [pred.predict_stream(pcm[i:i + piece],
                                is_end=i + piece >= len(pcm))
            for i in range(0, len(pcm), piece)]


@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_predict_and_batch_match_jax(predictors, device):
    jax_pred, port_pred = predictors[device]
    assert isinstance(port_pred._rescorer, AttentionRescoringDecoder)
    assert port_pred._rescorer.ctc_weight == 0.3
    assert port_pred._rescorer.max_hyp_len == 64
    pcms = [speechlike(int(s * 16000), 40 + i)
            for i, s in enumerate((2.3, 1.1, 3.0))]
    want = [jax_pred.predict(p) for p in pcms]
    assert all(len(r['text']) > 5 for r in want)
    _same([port_pred.predict(p) for p in pcms], want)
    _same(port_pred.predict_batch(pcms), jax_pred.predict_batch(pcms))


@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_stream_final_pass_matches_jax(artifact, predictors, device):
    jax_pred, port_pred = predictors[device]
    pcm = speechlike(int(2.7 * 16000), 4)
    want, got = _stream(jax_pred, pcm), _stream(port_pred, pcm)
    _same(got, want)
    # the partial results are greedy; the final one is the rescored pass
    greedy = PPASRPredictor(model_path=artifact, use_gpu=False,
                            use_device_frontend=device)
    partial = _stream(greedy, pcm)
    assert [r['text'] for r in got[:-1]] == [r['text'] for r in partial[:-1]]
    assert got[-1]['score'] != partial[-1]['score']
    assert port_pred._stream_probs_chunks
    assert all(t.device.type == 'cpu' for t in port_pred._stream_enc_chunks)
    port_pred.reset_stream()
    assert not port_pred._stream_enc_chunks
    assert not port_pred._stream_probs_chunks


@pytest.mark.parametrize('seed', [1])
def test_engine_final_pass_matches_jax(predictors, seed):
    jax_pred, port_pred = predictors[False]
    rng = np.random.default_rng(seed)
    pcms = [speechlike(int(rng.uniform(1.5, 3.0) * 16000), seed * 10 + i)
            for i in range(3)]
    got = engine_results(StreamingBatchEngine(port_pred, max_streams=4),
                         pcms)
    _same(got, engine_results(JaxEngine(jax_pred, max_streams=4), pcms))
    assert [r['text'] for r in got] == [
        _stream(port_pred, p)[-1]['text'] for p in pcms]


def test_rescorer_options_match_jax(artifact):
    conf = dict(CONF, rescore_ctc_weight=1.5, max_hyp_len=6,
                backend='native')
    jax_pred = JaxPredictor(model_path=artifact,
                            decoder='attention_rescoring',
                            decoder_configs=conf)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                               decoder='attention_rescoring',
                               decoder_configs=conf)
    assert port_pred._rescorer.ctc_weight == 1.5
    assert port_pred._rescorer.max_hyp_len == 6
    pcm = speechlike(int(1.7 * 16000), 9)
    _same([port_pred.predict(pcm)], [jax_pred.predict(pcm)])


def test_rescorer_that_cannot_be_built_raises(artifact, tmp_path):
    """A model without an attention decoder (ctc_weight 1): JAX falls back
    to greedy decoding, the port raises."""
    import json
    from flax import serialization
    for name in ('vocabulary.txt', 'mean_istd.json'):
        os.symlink(os.path.join(artifact, name), tmp_path / name)
    with open(os.path.join(artifact, 'model.msgpack'), 'rb') as f:
        tree = serialization.msgpack_restore(f.read())
    del tree['params']['decoder']
    (tmp_path / 'model.msgpack').write_bytes(
        serialization.msgpack_serialize(tree))
    with open(os.path.join(artifact, 'inference.json')) as f:
        conf = json.load(f)
    conf['model_conf'] = {'ctc_weight': 1.0}
    with open(tmp_path / 'inference.json', 'w') as f:
        json.dump(conf, f)
    with pytest.raises(ValueError, match='attention decoder'):
        PPASRPredictor(model_path=str(tmp_path), use_gpu=False,
                       decoder='attention_rescoring', decoder_configs=CONF)
    assert PPASRPredictor(model_path=str(tmp_path), use_gpu=False
                          ).model.decoder is None


def test_predictor_loads_every_leaf(predictors):
    model = predictors[False][1].model
    n_dec = sum(p.numel() for p in model.decoder.parameters())
    assert model.decoder.right_decoder is not None and n_dec > 0
    with torch.no_grad():
        assert all(torch.isfinite(p).all() for p in model.parameters())
