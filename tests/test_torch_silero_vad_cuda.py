"""The Silero VAD scorer and the punctuation model on the card against the
same modules on the CPU (pinned to the JAX package by
tests/test_torch_{silero_vad,punctuation}.py). These tests skip without a
card; the file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_silero_vad_cuda.py

Tolerances: speech probabilities within 1e-5 (float32, TF32 off); the
LSTM state after the 90 recurrent steps within 1e-4 absolute plus 1e-4
relative (cuDNN's LSTM sums in its own order, and the rounding carries
from step to step in the unbounded cell state: an NVIDIA H100 80GB HBM3
read 2.2e-5 on one element of 128); speech timestamps and punctuation
labels equal."""
import numpy as np
import pytest
import torch

from ppasr_tpu_torch.infer_utils import pun_predictor, silero
from ppasr_tpu_torch.infer_utils.vad_predictor import (VADPredictor,
                                                       packaged_silero_path)
from ppasr_tpu_torch.predict import ieee_float32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the VAD and punctuation models are checked here on a "
                    "card; their CPU paths are tested against JAX elsewhere")
    return torch.device('cuda:0')


def _recording(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(48000) / 16000.0
    voiced = sum(np.sin(2 * np.pi * k * 140 * t) / k for k in range(1, 10))
    env = (np.sin(2 * np.pi * 0.5 * t) > 0).astype(np.float32)
    return (0.2 * env * voiced + 0.002 * rng.standard_normal(t.size)).astype(
        np.float32)


@pytest.mark.gpu
def test_silero_on_card_matches_cpu():
    dev = _card()
    branch = silero.load_branch(packaged_silero_path(), 16000)
    cpu = silero.SileroNet(*branch).eval()
    card = silero.SileroNet(*branch).to(dev).eval()
    windows = torch.from_numpy(_recording(0)[:512 * 90].reshape(90, 512))
    h = torch.zeros(2, 1, 64)
    c = torch.zeros(2, 1, 64)
    with torch.inference_mode(), ieee_float32():
        want = cpu.score_windows(windows, h, c)
        got = card.score_windows(windows.to(dev), h.to(dev), c.to(dev))
    assert got[0].is_cuda
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    wav = _recording(1)
    with ieee_float32():
        assert VADPredictor(device=dev).get_speech_timestamps(wav) == \
            VADPredictor(device='cpu').get_speech_timestamps(wav)


@pytest.mark.gpu
def test_punctuation_on_card_matches_cpu():
    dev = _card()
    text = '近几年不但我用书给女儿压岁也劝说亲朋不要给女儿压岁钱而改送压岁书' * 3
    cpu = pun_predictor.PunctuationPredictor(device='cpu')
    card = pun_predictor.PunctuationPredictor(device=dev)
    with ieee_float32():
        np.testing.assert_array_equal(card.labels_of(text),
                                      cpu.labels_of(text))
        assert card(text) == cpu(text)
