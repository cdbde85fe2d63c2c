"""Port parity of the entry points for the model zoo: DeepSpeech2 (LSTM),
Squeezeformer and EfficientConformer at tiny widths
(``torch_tiny_artifact.ZOO``, weights from make_torch_zoo_fixture's
``fill_weights`` written by ``export_params``), each exported artifact
decoded by the JAX ``PPASRPredictor`` and by the port's (``use_gpu=False``,
the fbank kernel's plain version on the CPU) on the same PCM. Greedy texts
must be identical:

- ``predict`` and ``predict_batch`` (five utterances) on the host and the
  device frontend;
- ``predict_stream`` in 0.16 s pieces on both frontends;
- ``StreamingBatchEngine`` over three staggered streams;
- ``models/streaming_eval.streaming_greedy_batch`` (texts, ids and output
  lengths; DeepSpeech2 raises there, as the JAX trainer raises for it);
- the CLI, ``infer_path.main`` with the family's committed config,
  offline and simulated streaming;
- attention rescoring raises for DeepSpeech2, which has no attention
  decoder (the attention families' rescoring scores are checked in their
  own test files, and their rescoring ``predict`` on the card by
  ``chip_smoke.py``'s zoo phase).

The device frontend with ``mfcc`` or ``linear`` features raises.
"""
import json
import os
import sys

import numpy as np
import pytest

from ppasr_tpu.data.audio import AudioSegment as JaxSegment
from ppasr_tpu.decoders.greedy import _collapse as jax_collapse
from ppasr_tpu.models import streaming_eval as jax_eval
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu.serving import StreamingBatchEngine as JaxEngine
from ppasr_tpu_torch import infer_path
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.decoders.greedy import _collapse
from ppasr_tpu_torch.models import streaming_eval
from ppasr_tpu_torch.ops import fbank_cuda
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.serving import StreamingBatchEngine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402
from make_torch_zoo_fixture import RESCORE_CONF  # noqa: E402
from torch_tiny_artifact import ZOO, speechlike, write_zoo_artifact  # noqa: E402
from torch_train_util import one_torch_thread  # noqa: E402,F401

ROOT = fx.ROOT
PCMS = [speechlike(int(s * 16000), seed) for s, seed in
        ((2.3, 31), (1.7, 32), (3.1, 33))]


@pytest.fixture(scope='module', params=sorted(ZOO))
def zoo(request, tmp_path_factory):
    use_model = request.param
    artifact = write_zoo_artifact(tmp_path_factory.mktemp(use_model),
                                  use_model)
    preds = {
        'jax_device': JaxPredictor(model_path=artifact,
                                   use_device_frontend=True),
        'jax_host': JaxPredictor(model_path=artifact),
        'port_device': PPASRPredictor(model_path=artifact, use_gpu=False,
                                      use_device_frontend=True),
        'port_host': PPASRPredictor(model_path=artifact, use_gpu=False),
    }
    return use_model, artifact, preds


def _texts(results):
    return [r['text'] for r in results]


@pytest.mark.parametrize('frontend', ['host', 'device'])
def test_predict_and_batch_match_jax(zoo, frontend):
    use_model, _, preds = zoo
    jp, tp = preds[f'jax_{frontend}'], preds[f'port_{frontend}']
    want = [jp.predict(p) for p in PCMS]
    got = [tp.predict(p) for p in PCMS]
    assert _texts(got) == _texts(want)
    assert all(len(r['text']) > 5 for r in want), want
    np.testing.assert_allclose([r['score'] for r in got],
                               [r['score'] for r in want], atol=1e-3)
    before = fbank_cuda.launches
    utts = fx.batch_utts(PCMS)
    assert _texts(tp.predict_batch(utts)) == _texts(jp.predict_batch(utts))
    assert fbank_cuda.launches == before      # the CPU runs the plain path


@pytest.mark.parametrize('frontend', ['host', 'device'])
def test_stream_matches_jax(zoo, frontend):
    use_model, _, preds = zoo
    jp, tp = preds[f'jax_{frontend}'], preds[f'port_{frontend}']
    want = [fx.stream_text(jp, p) for p in PCMS]
    assert [fx.stream_text(tp, p) for p in PCMS] == want
    assert all(len(t) > 5 for t in want)


def test_engine_matches_jax(zoo):
    use_model, _, preds = zoo
    want = fx.engine_texts(JaxEngine(preds['jax_device'], max_streams=4),
                           PCMS)
    got = fx.engine_texts(StreamingBatchEngine(preds['port_device'],
                                               max_streams=4), PCMS)
    assert got == want and all(len(t) > 5 for t in want)


def test_streaming_greedy_batch_matches_jax(zoo):
    use_model, _, preds = zoo
    jp, tp = preds['jax_host'], preds['port_host']
    x, lens = fx.host_features(tp, PCMS)
    if use_model == 'deepspeech2':
        with pytest.raises(NotImplementedError, match='deepspeech2'):
            streaming_eval.streaming_greedy_batch(tp.model, x, lens)
        return
    ids, mp, olens = streaming_eval.streaming_greedy_batch(tp.model, x, lens)
    w_ids, w_mp, w_olens = jax_eval.streaming_greedy_batch(
        jp.model, jp.params, x, lens)
    np.testing.assert_array_equal(olens, w_olens)
    for b, n in enumerate(olens):
        np.testing.assert_array_equal(ids[b, :n], w_ids[b, :n])
    assert fx.rows_to_texts(_collapse, ids, mp, olens, tp.vocab_list) == \
        fx.rows_to_texts(jax_collapse, w_ids, w_mp, w_olens, jp.vocab_list)


def test_infer_path_matches_jax(zoo, tmp_path):
    use_model, artifact, preds = zoo
    wav = str(tmp_path / 'utt.wav')
    JaxSegment(PCMS[2], 16000).to_wav_file(wav)
    args = ['--configs', os.path.join(ROOT, 'configs', f'{use_model}.yml'),
            '--model_path', artifact, '--wav_path', wav, '--decoder',
            'ctc_greedy', '--use_gpu', 'False']
    assert infer_path.main(args)['text'] == \
        preds['jax_host'].predict(wav)['text']
    samples = JaxSegment.from_file(wav).samples
    jp = preds['jax_host']
    jp.reset_stream()
    for i in range(0, len(samples), 8000):
        want = jp.predict_stream(samples[i:i + 8000],
                                 is_end=i + 8000 >= len(samples))
    assert infer_path.main(args + ['--real_time_demo', 'True'])['text'] \
        == want['text']


def test_rescoring_raises_for_deepspeech2(tmp_path):
    artifact = write_zoo_artifact(tmp_path, 'deepspeech2')
    with pytest.raises(ValueError, match='no attention decoder'):
        PPASRPredictor(model_path=artifact, use_gpu=False,
                       decoder='attention_rescoring',
                       decoder_configs=dict(RESCORE_CONF))


@pytest.mark.parametrize('method', ['mfcc', 'linear'])
def test_device_frontend_is_fbank_only(tmp_path, method):
    artifact = write_zoo_artifact(tmp_path, 'deepspeech2')
    conf = json.loads(json.dumps(load_config(os.path.join(
        ROOT, 'configs', 'deepspeech2.yml'))))
    conf['preprocess_conf']['feature_method'] = method
    with pytest.raises(ValueError, match='fbank features only'):
        PPASRPredictor(configs=conf, model_path=artifact, use_gpu=False,
                       use_device_frontend=True)
