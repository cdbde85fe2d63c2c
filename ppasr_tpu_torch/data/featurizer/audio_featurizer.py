"""Host-side audio featurizer (counterpart of
ppasr_tpu/data/featurizer/audio_featurizer.py:14-62): resample →
dB-normalize → one of ``fbank`` (kaldi log-mel, ``ops/fbank.fbank_numpy``),
``mfcc`` (``mfcc_numpy``) or ``linear`` (log power spectrogram,
``linear_numpy``), or with ``waveform`` the same sample-domain prep alone,
for the device frontend of ``PPASRPredictor.predict_batch``. Dither only
when ``train=True`` (fbank and mfcc)."""
import numpy as np

from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.ops.fbank import fbank_numpy, linear_numpy, mfcc_numpy

FEATURE_METHODS = ('fbank', 'mfcc', 'linear')


class AudioFeaturizer:
    def __init__(self,
                 feature_method: str = 'fbank',
                 n_mels: int = 80,
                 n_mfcc: int = 40,
                 sample_rate: int = 16000,
                 use_dB_normalization: bool = True,
                 target_dB: float = -20,
                 train: bool = False):
        if feature_method not in FEATURE_METHODS:
            raise ValueError(f"unsupported feature method: {feature_method}")
        self._feature_method = feature_method
        self._target_sample_rate = sample_rate
        self._n_mels = n_mels
        self._n_mfcc = n_mfcc
        self._use_dB_normalization = use_dB_normalization
        self._target_dB = target_dB
        self._train = train
        self._rng = np.random.default_rng()

    def featurize(self, audio_segment: AudioSegment) -> np.ndarray:
        """AudioSegment → [T, feature_dim] float32 features."""
        if audio_segment.sample_rate != self._target_sample_rate:
            audio_segment.resample(self._target_sample_rate)
        if self._use_dB_normalization:
            audio_segment.normalize(target_db=self._target_dB)
        sr = audio_segment.sample_rate
        if self._feature_method == 'linear':
            return linear_numpy(audio_segment.samples, sr)
        dither = 1.0 if self._train else 0.0
        samples = audio_segment.to('int16').astype(np.float32)
        if self._feature_method == 'mfcc':
            return mfcc_numpy(samples, sr, num_mel_bins=self._n_mels,
                              num_ceps=self._n_mfcc, dither=dither,
                              rng=self._rng)
        return fbank_numpy(samples, sr, num_mel_bins=self._n_mels,
                           dither=dither, rng=self._rng)

    def waveform(self, audio_segment: AudioSegment) -> np.ndarray:
        """AudioSegment → int16-scaled float32 waveform with the same
        sample-domain prep as ``featurize`` (resample + dB-normalize), for
        a frontend that runs the fbank on the device."""
        if audio_segment.sample_rate != self._target_sample_rate:
            audio_segment.resample(self._target_sample_rate)
        if self._use_dB_normalization:
            audio_segment.normalize(target_db=self._target_dB)
        return audio_segment.to('int16').astype(np.float32)

    @property
    def feature_dim(self) -> int:
        """161 for ``linear``, ``n_mfcc`` for ``mfcc``, ``n_mels`` for
        ``fbank``."""
        return {'linear': 161, 'mfcc': self._n_mfcc,
                'fbank': self._n_mels}[self._feature_method]
