"""Port parity of the predictor: the tiny exported artifact of
tests/torch_tiny_artifact.py decoded by the JAX
``PPASRPredictor(use_device_frontend=True)`` (the Pallas fbank in interpret
mode on the CPU) and by the port's (``use_gpu=False``, the plain fbank).
Texts must be identical, offline and streamed in 0.16 s pieces. Also the
precision context ``ieee_float32`` across threads."""
import os
import sys
import threading

import pytest
import torch

from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu_torch import predict as port_predict
from ppasr_tpu_torch.ops import fbank_cuda
from ppasr_tpu_torch.predict import PPASRPredictor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tiny_artifact import speechlike as _speechlike  # noqa: E402
from torch_tiny_artifact import write_artifact  # noqa: E402


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
    for name in ('ctc_beam_search', 'attention_rescoring'):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            PPASRPredictor(model_path=artifact, use_gpu=False, decoder=name)


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
