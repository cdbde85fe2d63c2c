"""Audio-domain augmentors (copy of
ppasr_tpu/data/augmentor/audio_augmentors.py:22-94), drawing from Python's
``random`` as the JAX package's do:

- ``NoisePerturbAugmentor``: SNR uniform in [min_snr_dB, max_snr_dB], the
  noise wrap-padded when shorter, overlaid 1..repetition times. Without a
  readable noise manifest (``dataset/manifest.noise`` is not in the
  repository) it leaves the audio as it is and draws nothing;
- ``SpeedPerturbAugmentor``: one of ``num_rates`` rates in
  [min_speed_rate, max_speed_rate];
- ``ShiftPerturbAugmentor``: a uniform shift in ms;
- ``VolumePerturbAugmentor``: a uniform gain in dBFS;
- ``ResampleAugmentor``: to a random listed rate and back.
"""
import random

import numpy as np

from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.data.augmentor.base import AugmentorBase
from ppasr_tpu_torch.data.manifest import read_manifest


class NoisePerturbAugmentor(AugmentorBase):
    def __init__(self, min_snr_dB=10, max_snr_dB=50, repetition=2,
                 noise_manifest_path=None):
        self.min_snr_dB = min_snr_dB
        self.max_snr_dB = max_snr_dB
        self.repetition = repetition
        self.noise_manifest = []
        if noise_manifest_path:
            try:
                self.noise_manifest = read_manifest(noise_manifest_path,
                                                    min_duration=0)
            except (IOError, FileNotFoundError):
                self.noise_manifest = []

    def transform_audio(self, audio_segment: AudioSegment):
        if not self.noise_manifest:
            return
        for _ in range(random.randint(1, self.repetition)):
            entry = random.choice(self.noise_manifest)
            snr = random.uniform(self.min_snr_dB, self.max_snr_dB)
            noise = AudioSegment.from_file(entry['audio_filepath'])
            if noise.sample_rate != audio_segment.sample_rate:
                noise.resample(audio_segment.sample_rate)
            if noise.duration < audio_segment.duration:
                reps = int(np.ceil(audio_segment.num_samples
                                   / noise.num_samples))
                noise = AudioSegment(
                    np.tile(noise.samples, reps)[:audio_segment.num_samples
                                                 + 1], noise.sample_rate)
            audio_segment.add_noise(noise, snr)


class SpeedPerturbAugmentor(AugmentorBase):
    def __init__(self, min_speed_rate=0.9, max_speed_rate=1.1, num_rates=3):
        if min_speed_rate < 0.9 or max_speed_rate > 1.1:
            raise ValueError("speed rates outside [0.9, 1.1] distort audio")
        self._rates = np.linspace(min_speed_rate, max_speed_rate, num_rates,
                                  endpoint=True)

    def transform_audio(self, audio_segment: AudioSegment):
        audio_segment.change_speed(float(random.choice(self._rates)))


class ShiftPerturbAugmentor(AugmentorBase):
    def __init__(self, min_shift_ms=-5, max_shift_ms=5):
        self.min_shift_ms = min_shift_ms
        self.max_shift_ms = max_shift_ms

    def transform_audio(self, audio_segment: AudioSegment):
        audio_segment.shift(random.uniform(self.min_shift_ms,
                                           self.max_shift_ms))


class VolumePerturbAugmentor(AugmentorBase):
    def __init__(self, min_gain_dBFS=-15, max_gain_dBFS=15):
        self.min_gain_dBFS = min_gain_dBFS
        self.max_gain_dBFS = max_gain_dBFS

    def transform_audio(self, audio_segment: AudioSegment):
        audio_segment.gain_db(random.uniform(self.min_gain_dBFS,
                                             self.max_gain_dBFS))


class ResampleAugmentor(AugmentorBase):
    def __init__(self, new_sample_rate=(8000, 32000, 44100, 48000)):
        self.new_sample_rate = list(new_sample_rate)

    def transform_audio(self, audio_segment: AudioSegment):
        orig = audio_segment.sample_rate
        audio_segment.resample(random.choice(self.new_sample_rate))
        audio_segment.resample(orig)
