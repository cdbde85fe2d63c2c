"""Port parity of the predictor: the tiny exported artifact of
tests/torch_tiny_artifact.py decoded by the JAX
``PPASRPredictor(use_device_frontend=True)`` (the Pallas fbank in interpret
mode on the CPU) and by the port's (``use_gpu=False``, the plain fbank).
Texts must be identical, offline and streamed in 0.16 s pieces. Also the
precision context ``ieee_float32`` across threads.

The beam-search cases (``decoder='ctc_beam_search'``) run both predictors
with the same ``decoder_configs``, with and without a random trigram LM over
the artifact's letters, on both frontends: texts identical, scores within
1e-4 absolute plus 1e-5 relative. The host and native backends and the
routing of a ``.klm`` LM to the native one are checked the same way, and so
are ``decoder='attention_rescoring'`` and ``compute_dtype='bfloat16'``
(texts identical, in bf16 or differing only at near ties:
tests/test_torch_{rescoring,bf16}.py hold them to their tolerances), and punctuation and ITN (texts identical)."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import ppasr_tpu.decoders.greedy as jax_greedy
import ppasr_tpu.predict as jax_predict
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu_torch import predict as port_predict
from ppasr_tpu_torch.decoders import greedy as port_greedy
from ppasr_tpu_torch.decoders.beam_search import BeamSearchDecoder
from ppasr_tpu_torch.decoders.beam_search_torch import TorchBeamSearchDecoder
from ppasr_tpu_torch.decoders.klm import write_klm_from_scorer
from ppasr_tpu_torch.decoders.lm import NgramScorer
from ppasr_tpu_torch.decoders.native import NativeBeamSearchDecoder
from ppasr_tpu_torch.ops import fbank_cuda
from ppasr_tpu_torch.predict import PPASRPredictor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402
from torch_tiny_artifact import CHARS, random_arpa  # noqa: E402
from torch_tiny_artifact import speechlike as _speechlike  # noqa: E402
from torch_tiny_artifact import write_artifact  # noqa: E402

BEAM_CONF = dict(beam_size=24, cutoff_top_n=12, cutoff_prob=0.99, alpha=0.3,
                 beta=1.5)


@pytest.fixture(scope='module')
def artifact(tmp_path_factory):
    return write_artifact(tmp_path_factory.mktemp('tiny_artifact'))


@pytest.fixture(scope='module')
def predictors(artifact):
    jax_pred = JaxPredictor(model_path=artifact, use_device_frontend=True)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                               use_device_frontend=True)
    return jax_pred, port_pred


def _stream(pred, pcm, piece=2560):
    pred.reset_stream()
    results = []
    for i in range(0, len(pcm), piece):
        results.append(pred.predict_stream(pcm[i:i + piece],
                                           is_end=i + piece >= len(pcm)))
    return results


@pytest.mark.parametrize('seed,seconds', [(1, 2.3), (2, 3.1)])
def test_predict_and_stream_texts_identical(predictors, seed, seconds):
    jax_pred, port_pred = predictors
    pcm = _speechlike(int(seconds * 16000), seed)
    want = jax_pred.predict(pcm)
    got = port_pred.predict(pcm)
    assert got['text'] == want['text'] and len(want['text']) > 10
    assert abs(got['score'] - want['score']) < 1e-2
    before = fbank_cuda.launches
    want_s = _stream(jax_pred, pcm)
    got_s = _stream(port_pred, pcm)
    assert [r['text'] for r in got_s] == [r['text'] for r in want_s]
    assert len(want_s[-1]['text']) > 10
    assert fbank_cuda.launches == before      # the CPU runs the plain path


def test_host_frontend_stream_matches_jax(artifact):
    jax_pred = JaxPredictor(model_path=artifact, use_device_frontend=False)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False)
    pcm = _speechlike(int(2.7 * 16000), 4)
    assert [r['text'] for r in _stream(port_pred, pcm)] == \
        [r['text'] for r in _stream(jax_pred, pcm)]


def test_unported_decoders_raise(artifact):
    """Every decoder of the JAX predictor is ported: an unknown one, an
    unknown beam backend and a model_tag download still raise."""
    with pytest.raises(NotImplementedError, match='network'):
        PPASRPredictor(model_path=artifact, use_gpu=False, model_tag='x')
    with pytest.raises(ValueError, match='unknown decoder'):
        PPASRPredictor(model_path=artifact, use_gpu=False, decoder='other')
    with pytest.raises(ValueError, match='backend'):
        PPASRPredictor(model_path=artifact, use_gpu=False,
                       decoder='ctc_beam_search',
                       decoder_configs={'backend': 'other'})


@pytest.fixture(scope='module')
def letters_lm(tmp_path_factory):
    """A random trigram ARPA over the tiny artifact's tokens, and its
    .klm."""
    tmp = tmp_path_factory.mktemp('letters_lm')
    arpa = random_arpa(tmp / 'letters.arpa', CHARS, order=3, seed=3,
                       n_per_order=300)
    klm = str(tmp / 'letters.klm')
    write_klm_from_scorer(klm, NgramScorer(arpa, CHARS))
    return arpa, klm


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _assert_same_results(got, want):
    assert [r['text'] for r in got] == [r['text'] for r in want]
    _close([r['score'] for r in got], [r['score'] for r in want])


@pytest.mark.parametrize('use_lm', [False, True], ids=['no_lm', 'trigram'])
@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_beam_search_matches_jax(artifact, letters_lm, device, use_lm):
    conf = dict(BEAM_CONF, language_model_path=letters_lm[0] if use_lm
                else None)
    jax_pred = JaxPredictor(model_path=artifact, use_device_frontend=device,
                            decoder='ctc_beam_search', decoder_configs=conf)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                               use_device_frontend=device,
                               decoder='ctc_beam_search',
                               decoder_configs=conf)
    dec = port_pred._beam_decoder
    assert isinstance(dec, TorchBeamSearchDecoder)
    assert dec.device == torch.device('cpu')
    assert (dec.lm_hash is not None) == use_lm
    for seed, seconds in ((1, 2.3), (6, 1.4)):
        pcm = _speechlike(int(seconds * 16000), seed)
        want, got = jax_pred.predict(pcm), port_pred.predict(pcm)
        assert len(want['text']) > 10
        _assert_same_results([got], [want])
        _assert_same_results(_stream(port_pred, pcm), _stream(jax_pred, pcm))
    port_pred.reset_stream()
    assert dec._state is None and dec.current() == (0.0, '')


@pytest.mark.parametrize('backend', ['host', 'native', 'klm'])
def test_host_and_native_backends_match_jax(artifact, letters_lm, backend):
    """``backend: 'host'`` and ``'native'`` with the ARPA LM, and a .klm LM
    under the default backend, which goes to the native decoder."""
    conf = dict(BEAM_CONF, language_model_path=letters_lm[0])
    if backend == 'klm':
        conf['language_model_path'] = letters_lm[1]
    else:
        conf['backend'] = backend
    jax_pred = JaxPredictor(model_path=artifact, decoder='ctc_beam_search',
                            decoder_configs=conf)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                               decoder='ctc_beam_search',
                               decoder_configs=conf)
    assert type(port_pred._beam_decoder) is (
        BeamSearchDecoder if backend == 'host' else NativeBeamSearchDecoder)
    pcm = _speechlike(int(1.9 * 16000), 7)
    _assert_same_results([port_pred.predict(pcm)], [jax_pred.predict(pcm)])
    _assert_same_results(_stream(port_pred, pcm), _stream(jax_pred, pcm))


def test_missing_cmvn_raises(artifact, tmp_path):
    for name in ('inference.json', 'model.msgpack', 'vocabulary.txt'):
        os.symlink(os.path.join(artifact, name), tmp_path / name)
    with pytest.raises(FileNotFoundError):
        PPASRPredictor(model_path=str(tmp_path), use_gpu=False,
                       mean_istd_path=str(tmp_path / 'absent.json'))


def test_model_runs_without_tf32_and_flags_are_restored(predictors,
                                                        monkeypatch):
    """compute_dtype='float32' is IEEE float32: the predictor turns TF32 off
    while its model runs, whatever the process set, and restores the flags."""
    port_pred = predictors[1]
    seen = []
    for name in ('get_encoder_out', 'get_encoder_out_chunk'):
        run = getattr(port_pred.model, name)

        def spy(*args, _run=run, **kw):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return _run(*args, **kw)
        monkeypatch.setattr(port_pred.model, name, spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    pcm = _speechlike(int(1.5 * 16000), 5)
    port_pred.predict(pcm)
    _stream(port_pred, pcm)
    assert len(seen) > 2 and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_ieee_float32_keeps_tf32_off_while_any_thread_is_inside(monkeypatch):
    """A enters, B enters, A leaves: TF32 stays off for B. B leaves: the
    flags the process had come back."""
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    a_in, b_in, a_out, b_may_leave = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with port_predict.ieee_float32():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with port_predict.ieee_float32():
            b_in.set()
            a_out.wait(10)
            seen['after_a_left'] = _flags()
            b_may_leave.wait(10)

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    a_out.wait(10)
    b_in.wait(10)
    seen['main_with_b_inside'] = _flags()
    b_may_leave.set()
    for t in threads:
        t.join(10)
    assert seen == {'after_a_left': (False, False),
                    'main_with_b_inside': (False, False)}
    assert _flags() == (True, True)


@pytest.mark.parametrize('decoder,dtype', [
    ('attention_rescoring', 'float32'), ('ctc_greedy', 'bfloat16')])
def test_rescoring_and_bf16_predict_match_jax(artifact, decoder, dtype):
    conf = dict(BEAM_CONF, max_hyp_len=64) if decoder != 'ctc_greedy' \
        else None
    jax_pred = JaxPredictor(model_path=artifact, use_device_frontend=True,
                            decoder=decoder, decoder_configs=conf,
                            compute_dtype=dtype)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                               use_device_frontend=True, decoder=decoder,
                               decoder_configs=conf, compute_dtype=dtype)
    pcm = _speechlike(int(2.1 * 16000), 8)

    def texts(pred):
        return [pred.predict(pcm)['text'],
                [r['text'] for r in _stream(pred, pcm)][-1]]
    if dtype == 'float32':
        want = texts(jax_pred)
        assert texts(port_pred) == want and len(want[0]) > 5
    else:       # bfloat16: equal, or differing only at near ties
        got, bad = fx.texts_under_near_ties(
            lambda: texts(jax_pred), (jax_predict, jax_greedy),
            lambda: texts(port_pred), (port_predict, port_greedy))
        assert not bad and len(got[0]) > 5


def test_punctuation_and_itn_match_jax(predictors, artifact):
    """``use_pun`` and ``is_itn`` on ``predict`` and ``predict_stream``
    (the JAX device-frontend stream drops both, so the stream is compared
    on the host frontend); the punctuation model sits on the predictor's
    device."""
    jax_pred, port_pred = predictors
    pcm = _speechlike(int(2.4 * 16000), 9)
    for opts in ({'use_pun': True, 'is_itn': True},):
        want = jax_pred.predict(pcm, **opts)
        assert port_pred.predict(pcm, **opts) == {
            'text': want['text'], 'score': pytest.approx(want['score'],
                                                         abs=1e-2)}
    assert port_pred._pun_predictor.device == port_pred.device
    jax_host = JaxPredictor(model_path=artifact)
    port_host = PPASRPredictor(model_path=artifact, use_gpu=False,
                               use_pun=True)
    assert port_host._pun_predictor is not None

    def final(pred):
        pred.reset_stream()
        for i in range(0, len(pcm), 2560):
            out = pred.predict_stream(pcm[i:i + 2560], use_pun=True,
                                      is_itn=True,
                                      is_end=i + 2560 >= len(pcm))
        return out['text']
    assert final(port_host) == final(jax_host)
    assert final(port_pred) == final(port_host)


def test_ieee_float32_keeps_bf16_reductions_in_float32(monkeypatch):
    """cuBLAS may reduce bf16 products in bf16; the context turns that off
    with TF32 and restores the process' setting."""
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, 'allow_bf16_reduced_precision_reduction',
                        True)
    with port_predict.ieee_float32():
        assert not matmul.allow_bf16_reduced_precision_reduction
    assert matmul.allow_bf16_reduced_precision_reduction
