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
within ``BEAM_SCORE_TOL`` (1e-3, the log-prob tolerance).

Attention rescoring at the same beam (300 hypotheses of up to 200 tokens
through the 3 + 3-block decoder): ``predict`` on the first utterance gives
the fixture's JAX text and score within ``BEAM_SCORE_TOL`` (one utterance
keeps the CPU run short; chip_smoke.py runs every entry point at full
width). In bfloat16, ``predict``, ``predict_batch``, ``predict_stream`` and
the engine give the fixture's JAX bf16 texts under the near-tie rule, and
the CTC log-probs lie within ``BF16_LOGPROB_TOL`` of JAX's bf16 ones
(tests/test_torch_bf16.py)."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
import ppasr_tpu_torch.decoders.greedy as port_greedy
import ppasr_tpu_torch.predict as port_predict
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.serving import StreamingBatchEngine

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
    assert port_pred.model.decoder is not None    # every leaf is loaded
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


def test_flagship_rescoring_matches_fixture(fixture, artifact):
    data, pcms = fixture
    pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                          use_device_frontend=True,
                          decoder='attention_rescoring',
                          decoder_configs=fx.beam_conf())
    assert pred._rescorer.beam.beam_size == 300
    assert pred._rescorer.max_hyp_len == 200
    got = pred.predict(pcms[0])
    assert got['text'] == str(data['jax_rescore_offline'][0])
    assert abs(got['score'] - float(data['jax_rescore_offline_scores'][0])) \
        <= fx.BEAM_SCORE_TOL


def test_flagship_bf16_matches_fixture(fixture, artifact, predictors):
    data, pcms = fixture
    pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                          use_device_frontend=True, compute_dtype='bfloat16')
    runs = {
        'offline': lambda: [pred.predict(p)['text'] for p in pcms],
        'batch_device': lambda: [r['text'] for r in pred.predict_batch(
            fx.batch_utts(pcms))],
        'stream': lambda: [fx.stream_text(pred, p) for p in pcms],
        'engine': lambda: fx.engine_texts(StreamingBatchEngine(
            pred, max_streams=4), pcms),
    }
    for name, run in runs.items():
        key = f'jax_bf16_{name}'
        with fx.PosteriorRecorder(port_predict, port_greedy) as rec:
            texts = run()
        assert not fx.near_tie_failures(
            texts, [str(t) for t in data[key]], [u[0] for u in rec.utts],
            data[key + '_ids'], data[key + '_margins'],
            data[key + '_frames']), name

    jax_pred = predictors[0]
    bf16 = jax_pred.model.clone(dtype=jax.numpy.bfloat16)
    log_probs = jax.jit(lambda p, s, l: bf16.apply(
        p, s, l, method='get_ctc_log_probs'))
    for pcm in pcms:
        feat = pred.audio_featurizer.featurize(pred._load_audio(pcm))
        padded, t = pred._pad_bucket(feat)
        lj, nj = log_probs(jax_pred.params, padded, np.asarray([t]))
        with torch.no_grad():
            lt, _ = pred.model.get_ctc_log_probs(torch.from_numpy(padded),
                                                 torch.tensor([t]))
        n = int(nj[0])
        assert np.abs(np.asarray(lj)[0, :n] - lt.numpy()[0, :n]).max() \
            <= fx.BF16_LOGPROB_TOL
