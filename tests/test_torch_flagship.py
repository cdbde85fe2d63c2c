"""Port parity at full width: the committed flagship streaming Conformer
(256-dim, 12 blocks, 40.3 M parameters) decoded by the JAX predictor and by
the port's on the CPU, on the three utterances of
tests/fixtures/torch_smoke_utts.npz (written by
tests/make_torch_smoke_fixture.py, which this test re-renders to show the
fixture is reproducible).

Transcripts must be identical to each other and to the JAX transcripts
recorded in the fixture. CTC log-probs must agree within 1e-3: the two
frameworks sum in other orders across 12 blocks of float32 matmuls.

At the flagship's beam conf (beam 300, cutoff_top_n 40, the trigram
lm/synth_lm.arpa through the hash tables), the port's ``predict``,
``predict_stream`` and device-frontend ``predict_batch``, and ``predict``
with ``backend='native'``, give the fixture's JAX beam texts, with scores
within ``BEAM_SCORE_TOL`` (1e-3, the log-prob tolerance)."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu_torch.predict import PPASRPredictor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402

LOGPROB_TOL = 1e-3


@pytest.fixture(scope='module')
def fixture():
    data = np.load(fx.OUT)
    pcms = np.split(data['pcm'], np.cumsum(data['lengths'])[:-1])
    return data, pcms


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    return fx.flagship_artifact(str(tmp_path_factory.mktemp('flagship')))


@pytest.fixture(scope='module')
def predictors(artifact):
    path = artifact
    jax_pred = JaxPredictor(model_path=path, use_device_frontend=True)
    port_pred = PPASRPredictor(model_path=path, use_gpu=False,
                               use_device_frontend=True)
    return jax_pred, port_pred


def test_fixture_is_reproducible(fixture):
    data, pcms = fixture
    texts = fx.sentences()
    assert list(data['texts']) == texts
    assert int(data['seed']) == fx.SEED and int(data['piece']) == fx.PIECE
    for mine, stored in zip(fx.render(texts), pcms):
        assert mine.dtype == stored.dtype == np.int16
        np.testing.assert_array_equal(mine, stored)
    assert os.path.getsize(fx.OUT) < 300_000


def test_flagship_transcripts_identical(fixture, predictors):
    data, pcms = fixture
    jax_pred, port_pred = predictors
    assert port_pred.skipped_params and all(
        p.startswith('decoder/') for p in port_pred.skipped_params)
    for i, pcm in enumerate(pcms):
        want_off, want_stream = data['jax_offline'][i], data['jax_stream'][i]
        assert jax_pred.predict(pcm)['text'] == want_off
        assert port_pred.predict(pcm)['text'] == want_off
        assert fx.stream_text(jax_pred, pcm) == want_stream
        assert fx.stream_text(port_pred, pcm) == want_stream


def test_flagship_log_probs_agree(fixture, predictors):
    _, pcms = fixture
    jax_pred, port_pred = predictors
    log_probs = jax.jit(lambda p, s, l: jax_pred.model.apply(
        p, s, l, method='get_ctc_log_probs'))
    for pcm in pcms:
        feat = port_pred.audio_featurizer.featurize(
            port_pred._load_audio(pcm))
        padded, t = port_pred._pad_bucket(feat)
        lj, nj = log_probs(jax_pred.params, padded, np.asarray([t]))
        with torch.no_grad():
            lt, nt = port_pred.model.get_ctc_log_probs(
                torch.from_numpy(padded), torch.tensor([t]))
        n = int(nj[0])
        assert n == int(nt[0]) > 0
        diff = np.abs(np.asarray(lj)[0, :n] - lt.numpy()[0, :n])
        assert diff.max() <= LOGPROB_TOL, diff.max()


def _expect(results, data, key):
    assert [r['text'] for r in results] == [str(t) for t in data[key]], key
    np.testing.assert_allclose([r['score'] for r in results],
                               data[key + '_scores'], rtol=0,
                               atol=fx.BEAM_SCORE_TOL, err_msg=key)


def test_flagship_beam_search_matches_fixture(fixture, artifact):
    data, pcms = fixture
    assert str(data['beam_lm']) == fx.BEAM_LM
    conf = fx.beam_conf(str(data['beam_conf']))
    assert conf == fx.beam_conf()
    pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                          use_device_frontend=True,
                          decoder='ctc_beam_search', decoder_configs=conf)
    dec = pred._beam_decoder
    assert (dec.beam_size, dec.cutoff_top_n) == (300, 40)
    assert dec.lm_hash is not None and dec.lm_hash.order == 3
    _expect([pred.predict(p) for p in pcms], data, 'jax_beam_offline')
    _expect([fx.stream_result(pred, p) for p in pcms], data,
            'jax_beam_stream')
    _expect(pred.predict_batch(fx.batch_utts(pcms)), data,
            'jax_beam_batch_device')
    native = PPASRPredictor(model_path=artifact, use_gpu=False,
                            decoder='ctc_beam_search',
                            decoder_configs=dict(conf, backend='native'))
    _expect([native.predict(p) for p in pcms], data, 'jax_beam_native')
