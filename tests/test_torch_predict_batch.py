"""Port parity of batched offline recognition: ``predict_batch`` of the JAX
package and of the port on the tiny artifact of tests/torch_tiny_artifact.py,
on both frontends. The host frontend featurizes each utterance with
``fbank_numpy``; the device frontend runs the batched fbank, ``fbank_jax``
(XLA) in JAX and the plain ``fbank_batch_torch`` on the port's CPU path.
Texts must be identical; scores within 1e-3 absolute (on the ×100 scale).
With ``decoder='ctc_beam_search'`` (the port's on-device search from the
CTC logits, ``get_encoder_logits``) and a random trigram LM: texts
identical, log-prob scores within 1e-4 absolute plus 1e-5 relative.

With ``decoder='attention_rescoring'``: texts identical, scores within 1e-4
absolute plus 1e-5 relative; with ``compute_dtype='bfloat16'``: texts equal
or differing only at near ties (tests/test_torch_bf16.py); with ``use_pun``
and ``is_itn``: texts identical.

Also ``fbank_batch_torch`` against ``fbank_jax`` under the fbank tolerance
of tests/test_torch_fbank.py (mean |Δ| < 1e-3, max < 0.05 log-mel), and the
card path's flat-batch layout rebuilt from the plain per-frame function."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppasr_tpu.decoders.greedy as jax_greedy
import ppasr_tpu.predict as jax_predict
from ppasr_tpu.ops.fbank import fbank_jax
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
import ppasr_tpu_torch.decoders.greedy as port_greedy
import ppasr_tpu_torch.predict as port_predict
from ppasr_tpu_torch.decoders.beam_search_torch import TorchBeamSearchDecoder
from ppasr_tpu_torch.ops import fbank as F
from ppasr_tpu_torch.ops import fbank_cuda
from ppasr_tpu_torch.predict import PPASRPredictor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402
from make_torch_smoke_fixture import speechlike as speechlike_f32  # noqa
from torch_tiny_artifact import (CHARS, random_arpa, speechlike,  # noqa
                                 write_artifact)


@pytest.fixture(scope='module')
def predictors(tmp_path_factory):
    artifact = write_artifact(tmp_path_factory.mktemp('tiny_artifact'))
    return {device: (JaxPredictor(model_path=artifact,
                                  use_device_frontend=device),
                     PPASRPredictor(model_path=artifact, use_gpu=False,
                                    use_device_frontend=device))
            for device in (False, True)}


def _utterances(n, seed):
    rng = np.random.default_rng(seed)
    return [speechlike(int(rng.uniform(0.5, 3.0) * 16000), seed * 10 + i)
            for i in range(n)]


@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
@pytest.mark.parametrize('n', [1, 3, 5])
def test_predict_batch_matches_jax(predictors, device, n):
    jax_pred, port_pred = predictors[device]
    audio = _utterances(n, seed=n)
    before = fbank_cuda.launches
    got = port_pred.predict_batch(audio)
    want = jax_pred.predict_batch(audio)
    assert fbank_cuda.launches == before      # the CPU runs the plain path
    assert len(got) == len(want) == n
    assert [r['text'] for r in got] == [r['text'] for r in want]
    assert all(len(r['text']) > 3 for r in want)
    for g, w in zip(got, want):
        assert abs(g['score'] - w['score']) < 1e-3


@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_predict_batch_beam_search_matches_jax(tmp_path, device, monkeypatch):
    artifact = write_artifact(tmp_path)
    conf = dict(beam_size=24, cutoff_top_n=12, cutoff_prob=0.99, alpha=0.3,
                beta=1.5, language_model_path=random_arpa(
                    tmp_path / 'letters.arpa', CHARS, order=3, seed=3,
                    n_per_order=300))
    jax_pred = JaxPredictor(model_path=artifact, use_device_frontend=device,
                            decoder='ctc_beam_search', decoder_configs=conf)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                               use_device_frontend=device,
                               decoder='ctc_beam_search',
                               decoder_configs=conf)
    assert isinstance(port_pred._beam_decoder, TorchBeamSearchDecoder)
    logits_calls = []
    run = port_pred.model.get_encoder_logits
    monkeypatch.setattr(port_pred.model, 'get_encoder_logits',
                        lambda *a: logits_calls.append(1) or run(*a))
    audio = _utterances(3, seed=7)
    before = fbank_cuda.launches
    got = port_pred.predict_batch(audio)
    want = jax_pred.predict_batch(audio)
    assert fbank_cuda.launches == before and logits_calls == [1]
    assert [r['text'] for r in got] == [r['text'] for r in want]
    assert all(len(r['text']) > 3 for r in want)
    np.testing.assert_allclose([r['score'] for r in got],
                               [r['score'] for r in want], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize('mode', ['attention_rescoring', 'bfloat16'])
@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_predict_batch_rescoring_and_bf16_match_jax(tmp_path, device, mode):
    artifact = write_artifact(tmp_path)
    opts = dict(decoder='attention_rescoring', decoder_configs=dict(
        beam_size=16, cutoff_top_n=12, cutoff_prob=0.99, alpha=0.3,
        beta=1.5, max_hyp_len=64)) if mode == 'attention_rescoring' else dict(
        compute_dtype='bfloat16')
    jax_pred = JaxPredictor(model_path=artifact, use_device_frontend=device,
                            **opts)
    port_pred = PPASRPredictor(model_path=artifact, use_gpu=False,
                               use_device_frontend=device, **opts)
    audio = _utterances(3, seed=8)
    before = fbank_cuda.launches
    if mode == 'attention_rescoring':
        got, want = port_pred.predict_batch(audio), \
            jax_pred.predict_batch(audio)
        assert [r['text'] for r in got] == [r['text'] for r in want]
        np.testing.assert_allclose([r['score'] for r in got],
                                   [r['score'] for r in want], rtol=1e-5,
                                   atol=1e-4)
    else:
        got, bad = fx.texts_under_near_ties(
            lambda: [r['text'] for r in jax_pred.predict_batch(audio)],
            (jax_predict, jax_greedy),
            lambda: [r['text'] for r in port_pred.predict_batch(audio)],
            (port_predict, port_greedy))
        assert not bad
    assert fbank_cuda.launches == before


@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_predict_batch_punctuation_and_itn_match_jax(predictors, device):
    jax_pred, port_pred = predictors[device]
    audio = _utterances(3, seed=9)
    for opts in ({'use_pun': True, 'is_itn': True},):
        assert [r['text'] for r in port_pred.predict_batch(audio, **opts)] \
            == [r['text'] for r in jax_pred.predict_batch(audio, **opts)]


@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_predict_batch_empty(predictors, device):
    assert predictors[device][1].predict_batch([]) == []


def _ragged_batch():
    wavs = np.stack([speechlike_f32(32000, seed=s) for s in (1, 2, 3)])
    lengths = np.array([32000, 20560, 399], np.int32)
    for row, n in zip(wavs, lengths):
        row[n:] = 0.0
    return wavs, lengths


def test_fbank_batch_torch_matches_fbank_jax():
    wavs, lengths = _ragged_batch()
    got, got_lens = F.fbank_batch_torch(torch.from_numpy(wavs),
                                        torch.from_numpy(lengths))
    want, want_lens = fbank_jax(jnp.asarray(wavs), jnp.asarray(lengths))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.shape == want.shape == (3, 198, 80)
    d = np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))
    assert d.mean() < 1e-3 and d.max() < 0.05
    cpu, cpu_lens = fbank_cuda.fbank_batch(torch.from_numpy(wavs),
                                           torch.from_numpy(lengths))
    assert torch.equal(cpu, got) and torch.equal(cpu_lens, got_lens)


def test_flat_batch_layout_rebuilds_each_row():
    """The card path frames the flat [B·S] buffer at stride 160 (frame
    b·k + t is row b's frame t, k = S/160) and drops each row's last two
    columns; through the plain per-frame function that gives
    ``fbank_batch_torch``'s rows."""
    wavs, lengths = _ragged_batch()
    bsz, s = wavs.shape
    k = s // 160
    flat = torch.from_numpy(wavs).reshape(-1)
    frames = F.frame_torch(flat[None], 400, 160, bsz * k - 2)[0]
    assert torch.equal(
        torch.cat([frames, frames.new_zeros(2, 400)]).view(
            bsz, k, 400)[:, :k - 2],
        F.frame_torch(torch.from_numpy(wavs), 400, 160, k - 2))
    mel = F.fbank_frames_torch(frames)
    got = torch.cat([mel, mel.new_zeros(2, 80)]).view(bsz, k, 80)[:, :k - 2]
    want, _ = F.fbank_batch_torch(torch.from_numpy(wavs),
                                  torch.from_numpy(lengths))
    assert torch.equal(got, want)
