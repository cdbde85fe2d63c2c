"""Port parity of long-audio recognition on the CPU: ``predict_long`` of
the JAX predictor and of the port (Silero VAD segments through
``predict_batch`` in groups of at most 32, joined with ``，``), with and
without punctuation and ITN, on the tiny artifact of
tests/torch_tiny_artifact.py and on the committed
flagship against the JAX results recorded in
tests/fixtures/torch_smoke_utts.npz. Texts and speech timestamps exact,
scores within 1e-3 (the greedy scores are on the ×100 scale)."""
import os
import sys

import numpy as np
import pytest

from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu_torch.infer_utils.vad_predictor import VADPredictor
from ppasr_tpu_torch.predict import PPASRPredictor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402
from torch_tiny_artifact import speechlike, write_artifact  # noqa: E402


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    return write_artifact(tmp_path_factory.mktemp('tiny_artifact'))


def _recording(n_utts, seed, gap=fx.LONG_GAP):
    rng = np.random.default_rng(seed)
    return fx.long_recording(
        [speechlike(int(rng.uniform(0.8, 2.0) * 16000), seed * 10 + i)
         for i in range(n_utts)], seed=seed, gap=gap)


def _same(got, want):
    assert got['text'] == want['text']
    assert abs(got['score'] - want['score']) < 1e-3


@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_predict_long_matches_jax(artifact, device):
    jax_pred = JaxPredictor(model_path=artifact, use_device_frontend=device)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                               use_device_frontend=device)
    wav = _recording(4, seed=3)
    want = jax_pred.predict_long(wav)
    assert want['text'].count('，') == 3
    _same(port_pred.predict_long(wav), want)
    opts = {'use_pun': True, 'is_itn': True}
    _same(port_pred.predict_long(wav, **opts),
          jax_pred.predict_long(wav, **opts))


def test_predict_long_groups_of_32(artifact, monkeypatch):
    """More than 32 segments go through predict_batch 32 at a time
    (tests/test_torch_infer_path.py runs predict_long with rescoring)."""
    jax_pred = JaxPredictor(model_path=artifact)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False)
    wav = _recording(34, seed=5, gap=16000)
    sizes = []
    run = port_pred.predict_batch
    monkeypatch.setattr(port_pred, 'predict_batch',
                        lambda parts, **k: sizes.append(len(parts))
                        or run(parts, **k))
    want = jax_pred.predict_long(wav, is_itn=True)
    got = port_pred.predict_long(wav, is_itn=True)
    n = len(port_pred._vad.get_speech_timestamps(wav / 32768.0))
    assert n > 32 and sizes == [32, n - 32]
    assert got['text'] == want['text'] and want['text'].count('，') >= 20
    np.testing.assert_allclose(got['score'], want['score'], rtol=1e-5,
                               atol=1e-4)


def test_silence_decodes_the_whole_recording(artifact):
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False)
    quiet = (np.random.default_rng(0).standard_normal(16000) * 3).astype(
        np.int16)
    jax_pred = JaxPredictor(model_path=artifact)
    _same(port_pred.predict_long(quiet), jax_pred.predict_long(quiet))
    assert port_pred._vad.get_speech_timestamps(quiet / 32768.0) == []


def test_flagship_predict_long_matches_fixture(tmp_path):
    data = np.load(fx.OUT)
    pcms = np.split(data['pcm'], np.cumsum(data['lengths'])[:-1])
    wav = fx.long_recording(pcms)
    stamps = VADPredictor(device='cpu').get_speech_timestamps(
        wav.astype(np.float32) / 32768.0)
    assert [[s['start'], s['end']] for s in stamps] == \
        data['jax_long_vad'].tolist()
    pred = PPASRPredictor(model_path=fx.flagship_artifact(str(tmp_path)),
                          use_gpu=False, use_device_frontend=True)
    for key, opts in (('jax_long', {}),
                      ('jax_long_pun_itn', {'use_pun': True,
                                            'is_itn': True})):
        got = pred.predict_long(wav, **opts)
        assert got['text'] == str(data[key])
        assert abs(got['score'] - float(data[key + '_score'])) < 1e-3
