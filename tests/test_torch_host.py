"""Port parity of the host-side copies: audio segment, featurizers, greedy
decoders and config loading, each against its ``ppasr_tpu`` original on the
same inputs. These are copies of framework-free code, so results must be
equal, not close."""
import os

import numpy as np
import pytest
from scipy.io import wavfile

from ppasr_tpu.config import load_config as jax_load_config
from ppasr_tpu.data.audio import AudioSegment as JaxSegment
from ppasr_tpu.data.featurizer.audio_featurizer import \
    AudioFeaturizer as JaxFeaturizer
from ppasr_tpu.data.featurizer.text_featurizer import \
    TextFeaturizer as JaxText
from ppasr_tpu.decoders import greedy as jax_greedy
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.data import audio as port_audio
from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.data.featurizer.audio_featurizer import AudioFeaturizer
from ppasr_tpu_torch.data.featurizer.text_featurizer import TextFeaturizer
from ppasr_tpu_torch.decoders import greedy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pcm(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(n)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def test_audio_segment_matches_jax(tmp_path):
    pcm = _pcm(12000)
    path = str(tmp_path / 'a.wav')
    JaxSegment(pcm, 16000).to_wav_file(path)
    cases = [(AudioSegment.from_file(path), JaxSegment.from_file(path)),
             (AudioSegment.from_pcm_bytes(pcm.tobytes()),
              JaxSegment.from_pcm_bytes(pcm.tobytes())),
             (AudioSegment.from_ndarray(pcm, 8000),
              JaxSegment.from_ndarray(pcm, 8000))]
    for mine, ref in cases:
        mine.resample(16000)
        ref.resample(16000)
        mine.normalize(-20)
        ref.normalize(-20)
        assert mine.sample_rate == ref.sample_rate == 16000
        np.testing.assert_array_equal(mine.samples, ref.samples)
        np.testing.assert_array_equal(mine.to('int16'), ref.to('int16'))
        assert mine.num_samples == ref.num_samples
        assert mine.rms_db == ref.rms_db


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_float_wav_loads_as_in_jax(tmp_path, dtype):
    """A float WAV, which the ``wave`` module rejects, loads through
    scipy.io.wavfile as in the JAX package."""
    path = str(tmp_path / 'f.wav')
    wavfile.write(path, 16000, (_pcm(8000, seed=3) / 32768.0).astype(dtype))
    mine, ref = AudioSegment.from_file(path), JaxSegment.from_file(path)
    assert mine.sample_rate == ref.sample_rate == 16000
    np.testing.assert_array_equal(mine.samples, ref.samples)
    with open(path, 'rb') as f:
        np.testing.assert_array_equal(AudioSegment.from_file(f).samples,
                                      ref.samples)


def test_undecodable_file_without_ffmpeg_raises_as_jax(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / 'x.mp3')
    with open(path, 'wb') as f:
        f.write(b'ID3 not a wav file' * 8)
    monkeypatch.setattr(port_audio.shutil, 'which', lambda name: None)
    monkeypatch.setattr('shutil.which', lambda name: None)
    with pytest.raises(ValueError) as mine:
        AudioSegment.from_file(path)
    with pytest.raises(ValueError) as ref:
        JaxSegment.from_file(path)
    assert str(mine.value) == str(ref.value)
    assert 'ffmpeg is not installed' in str(mine.value)


@pytest.mark.parametrize('dbnorm', [True, False])
def test_audio_featurizer_matches_jax(dbnorm):
    """fbank, mfcc and linear features equal the JAX featurizer's, as do
    their feature dimensions; an unknown method raises."""
    pcm = _pcm(9000, seed=1)
    for method in ('fbank', 'mfcc', 'linear'):
        mine = AudioFeaturizer(feature_method=method, n_mels=80,
                               use_dB_normalization=dbnorm)
        ref = JaxFeaturizer(feature_method=method, n_mels=80,
                            use_dB_normalization=dbnorm)
        got = mine.featurize(AudioSegment(pcm, 16000))
        np.testing.assert_array_equal(
            got, ref.featurize(JaxSegment(pcm, 16000)))
        assert got.shape[1] == mine.feature_dim == ref.feature_dim
    with pytest.raises(ValueError, match='unsupported feature method'):
        AudioFeaturizer(feature_method='spectrogram')


@pytest.mark.parametrize('n_mels,n_ceps,lifter', [(80, 40, 22.0),
                                                  (40, 13, 0.0)])
def test_mfcc_and_linear_numpy_match_jax(n_mels, n_ceps, lifter):
    """ops/fbank's mfcc_numpy, dct_matrix, lifter_coeffs and linear_numpy
    against ppasr_tpu/ops/fbank.py's, bit for bit."""
    from ppasr_tpu.ops import fbank as jax_fbank
    from ppasr_tpu_torch.ops import fbank as port_fbank
    wav = _pcm(7000, seed=2).astype(np.float32) * 32767.0
    np.testing.assert_array_equal(port_fbank.dct_matrix(n_ceps, n_mels),
                                  jax_fbank.dct_matrix(n_ceps, n_mels))
    np.testing.assert_array_equal(port_fbank.lifter_coeffs(n_ceps, 22.0),
                                  jax_fbank.lifter_coeffs(n_ceps, 22.0))
    np.testing.assert_array_equal(
        port_fbank.mfcc_numpy(wav, num_mel_bins=n_mels, num_ceps=n_ceps,
                              cepstral_lifter=lifter),
        jax_fbank.mfcc_numpy(wav, num_mel_bins=n_mels, num_ceps=n_ceps,
                             cepstral_lifter=lifter))
    for n in (7000, 200):       # 200 samples: no whole 20 ms frame
        x = _pcm(n, seed=3)
        np.testing.assert_array_equal(port_fbank.linear_numpy(x, 16000),
                                      jax_fbank.linear_numpy(x, 16000))


def test_text_featurizer_and_greedy_match_jax():
    vocab = os.path.join(ROOT, 'dataset', 'vocabulary.txt')
    mine, ref = TextFeaturizer(vocab), JaxText(vocab)
    assert mine.vocab_list == ref.vocab_list
    assert mine.featurize('消耗 创建x') == ref.featurize('消耗 创建x')
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(40, len(mine.vocab_list))) * 3
    logits[::3, 0] += 6                       # blanks between tokens
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    assert greedy.greedy_decoder(probs, mine.vocab_list) == \
        jax_greedy.greedy_decoder(probs, ref.vocab_list)
    dm = greedy.GreedyStreamingDecoder(mine.vocab_list)
    dr = jax_greedy.GreedyStreamingDecoder(ref.vocab_list)
    assert dm.current() == dr.current()
    for chunk in np.split(probs, [7, 16, 16, 33]):
        assert dm.decode_chunk(chunk) == dr.decode_chunk(chunk)


def test_load_config_matches_jax():
    for name in ('conformer.yml', os.path.join('campaign',
                                               'conformer_synth.yml')):
        path = os.path.join(ROOT, 'configs', name)
        mine, ref = load_config(path), jax_load_config(path)
        assert mine == ref
        assert mine.encoder_conf.output_size == ref.encoder_conf.output_size
