"""In-memory mono float32 audio segment.

Copy of what the predictor and the trainer use of
ppasr_tpu/data/audio.py:23-395: ``from_ndarray``, ``from_pcm_bytes``,
``from_file``, ``slice_from_file``, ``to_wav_file``, ``normalize``,
``resample`` (scipy polyphase), ``to``, and the transforms that the audio
augmentors call: ``gain_db``, ``change_speed`` (linear interpolation),
``shift``, ``subsegment``, ``random_subsegment`` and ``add_noise``. ``from_file`` reads integer-PCM WAV
through the standard ``wave`` module, falls back to ``scipy.io.wavfile``
for the WAV formats ``wave`` rejects (float WAV), and then to an ``ffmpeg``
subprocess for other containers (mp3, flac, opus) where ffmpeg is installed
(``_read_wav`` and ``_read_via_ffmpeg``, :347-395 there).
"""
import random
import shutil
import struct
import subprocess
import wave

import numpy as np
from scipy import signal


class AudioSegment:
    """Mono float32 audio in [-1, 1] with a sample rate."""

    def __init__(self, samples: np.ndarray, sample_rate: int):
        self._samples = self._convert_samples_to_float32(samples)
        self._sample_rate = int(sample_rate)
        if self._samples.ndim >= 2:
            self._samples = np.mean(self._samples, axis=1)

    # ------------------------------------------------------------- constructors

    @classmethod
    def from_file(cls, file) -> "AudioSegment":
        """Load an audio file (path or file object): WAV, or another
        container through ffmpeg."""
        samples, sr = _read_wav(file)
        return cls(samples, sr)

    @classmethod
    def slice_from_file(cls, file, start=None, end=None) -> "AudioSegment":
        """The [start, end] seconds of a WAV file, read by seeking (negative
        times count from the end)."""
        with wave.open(file, "rb") as wf:
            sr = wf.getframerate()
            duration = wf.getnframes() / sr
            start = 0.0 if start is None else start
            end = duration if end is None else end
            if start < 0.0:
                start += duration
            if end < 0.0:
                end += duration
            start = max(0.0, start)
            end = min(duration, end)
            if end < start:
                raise ValueError(f"slice end ({end}) < start ({start})")
            start_frame = int(start * sr)
            wf.setpos(start_frame)
            data = wf.readframes(int(end * sr) - start_frame)
            samples = _decode_frames(data, wf.getsampwidth(),
                                     wf.getnchannels())
        return cls(samples, sr)

    @classmethod
    def from_pcm_bytes(cls, data: bytes, channels=1, samp_width=2,
                       sample_rate=16000) -> "AudioSegment":
        """Raw PCM bytes → segment."""
        dtype = {1: np.int8, 2: np.int16, 4: np.int32}[samp_width]
        samples = np.frombuffer(data, dtype=dtype)
        if channels > 1:
            samples = samples.reshape(-1, channels)
        return cls(samples, sample_rate)

    @classmethod
    def from_ndarray(cls, data: np.ndarray, sample_rate=16000) -> "AudioSegment":
        return cls(data, sample_rate)

    def to(self, dtype="int16") -> np.ndarray:
        """Samples rescaled to an integer dtype's range; kaldi-style
        featurizers consume int16-scaled float samples."""
        return self._convert_samples_from_float32(self._samples, dtype)

    def to_wav_file(self, filepath, dtype="int16"):
        samples = self._convert_samples_from_float32(self._samples, dtype)
        with wave.open(filepath, "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth({"int16": 2, "int32": 4}[dtype])
            wf.setframerate(self._sample_rate)
            wf.writeframes(samples.tobytes())

    # --------------------------------------------------------------- transforms

    def gain_db(self, gain: float):
        """Apply gain in dB in place."""
        self._samples *= 10. ** (gain / 20.)

    def change_speed(self, speed_rate: float):
        """Time-stretch by linear interpolation."""
        if speed_rate == 1.0:
            return
        if speed_rate <= 0:
            raise ValueError("speed_rate must be positive")
        old_length = self._samples.shape[0]
        new_length = int(old_length / speed_rate)
        self._samples = np.interp(np.linspace(0, old_length, new_length),
                                  np.arange(old_length),
                                  self._samples).astype(np.float32)

    def shift(self, shift_ms: float):
        """Shift in time, zero-filling the vacated span."""
        shift_samples = int(shift_ms * self._sample_rate / 1000)
        if abs(shift_samples) > self.num_samples:
            raise ValueError("shift_ms exceeds audio duration")
        if shift_samples > 0:
            self._samples[shift_samples:] = self._samples[:-shift_samples]
            self._samples[:shift_samples] = 0
        elif shift_samples < 0:
            self._samples[:shift_samples] = self._samples[-shift_samples:]
            self._samples[shift_samples:] = 0

    def subsegment(self, start_sec=None, end_sec=None):
        """Cut to [start, end] seconds in place."""
        start_sec = 0.0 if start_sec is None else start_sec
        end_sec = self.duration if end_sec is None else end_sec
        if start_sec < 0.0:
            start_sec += self.duration
        if end_sec < 0.0:
            end_sec += self.duration
        if start_sec < 0.0 or end_sec > self.duration or end_sec < start_sec:
            raise ValueError(f"bad subsegment bounds [{start_sec}, {end_sec}]")
        self._samples = self._samples[int(round(start_sec * self._sample_rate)):
                                      int(round(end_sec * self._sample_rate))]

    def random_subsegment(self, subsegment_length: float):
        """A cut of the given duration at a random start (``random``)."""
        if subsegment_length > self.duration:
            raise ValueError("subsegment length > audio duration")
        start_time = random.uniform(0.0, self.duration - subsegment_length)
        self.subsegment(start_time, start_time + subsegment_length)

    def add_noise(self, noise: "AudioSegment", snr_dB: float,
                  max_gain_db=300.0):
        """Overlay a random cut of ``noise`` (at least as long as this
        segment) at the given SNR."""
        if noise.sample_rate != self.sample_rate:
            raise ValueError("noise sample rate mismatch")
        if noise.duration < self.duration:
            raise ValueError("noise shorter than audio")
        noise_gain_db = min(self.rms_db - noise.rms_db - snr_dB, max_gain_db)
        noise_new = AudioSegment(noise.samples.copy(), noise.sample_rate)
        noise_new.random_subsegment(self.duration)
        noise_new.gain_db(noise_gain_db)
        n = min(self.num_samples, noise_new.num_samples)
        self._samples[:n] += noise_new.samples[:n]

    def normalize(self, target_db=-20, max_gain_db=300.0):
        """Gain to an RMS target in dBFS."""
        gain = target_db - self.rms_db
        if gain > max_gain_db:
            raise ValueError(
                f"cannot normalize to {target_db}dB without exceeding "
                f"max_gain_db ({max_gain_db}dB)")
        self.gain_db(min(max_gain_db, gain))

    def resample(self, target_sample_rate: int):
        """Polyphase resample."""
        if target_sample_rate == self._sample_rate:
            return
        g = np.gcd(self._sample_rate, target_sample_rate)
        up, down = target_sample_rate // g, self._sample_rate // g
        self._samples = signal.resample_poly(self._samples, up,
                                             down).astype(np.float32)
        self._sample_rate = target_sample_rate

    # -------------------------------------------------------------- properties

    @property
    def samples(self) -> np.ndarray:
        return self._samples.copy()

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def num_samples(self) -> int:
        return self._samples.shape[0]

    @property
    def duration(self) -> float:
        return self._samples.shape[0] / float(self._sample_rate)

    @property
    def rms_db(self) -> float:
        mean_square = np.mean(self._samples ** 2)
        if mean_square <= 0:
            return -np.inf
        return 10 * np.log10(mean_square)

    # ----------------------------------------------------------------- helpers

    @staticmethod
    def _convert_samples_to_float32(samples: np.ndarray) -> np.ndarray:
        """int PCM → float32 in [-1, 1]."""
        samples = np.asarray(samples)
        float32_samples = samples.astype(np.float32)
        if samples.dtype.kind in "iu":
            bits = np.iinfo(samples.dtype).bits
            float32_samples *= 1.0 / 2 ** (bits - 1)
        elif samples.dtype.kind != "f":
            raise TypeError(f"unsupported sample dtype: {samples.dtype}")
        return float32_samples

    @staticmethod
    def _convert_samples_from_float32(samples: np.ndarray, dtype) -> np.ndarray:
        """float32 [-1,1] → target dtype with scaling."""
        dtype = np.dtype(dtype)
        output = samples.copy()
        if dtype.kind in "iu":
            bits = np.iinfo(dtype).bits
            output *= 2 ** (bits - 1)
            min_val, max_val = np.iinfo(dtype).min, np.iinfo(dtype).max
            output = np.clip(output, min_val, max_val)
        elif dtype.kind != "f":
            raise TypeError(f"unsupported target dtype: {dtype}")
        return output.astype(dtype)


def _decode_frames(data: bytes, sampwidth: int, nchannels: int) -> np.ndarray:
    if sampwidth == 2:
        samples = np.frombuffer(data, dtype=np.int16)
    elif sampwidth == 4:
        samples = np.frombuffer(data, dtype=np.int32)
    elif sampwidth == 1:
        samples = np.frombuffer(data, dtype=np.uint8).astype(np.int16) - 128
        samples = (samples * 256).astype(np.int16)
    elif sampwidth == 3:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        samples = ((raw[:, 2].astype(np.int32) << 24)
                   | (raw[:, 1].astype(np.int32) << 16)
                   | (raw[:, 0].astype(np.int32) << 8)) >> 8
    else:
        raise ValueError(f"unsupported sample width: {sampwidth}")
    if nchannels > 1:
        samples = samples.reshape(-1, nchannels)
    return samples


def _read_wav(file):
    """(samples, sample rate) of a WAV file: through ``wave``, then
    ``scipy.io.wavfile`` for the WAV formats ``wave`` rejects (float
    samples), then ``_read_via_ffmpeg`` for other containers."""
    try:
        with wave.open(file, "rb") as wf:
            sr = wf.getframerate()
            data = wf.readframes(wf.getnframes())
            samples = _decode_frames(data, wf.getsampwidth(),
                                     wf.getnchannels())
        return samples, sr
    except (wave.Error, EOFError, struct.error):
        pass
    try:
        from scipy.io import wavfile
        if hasattr(file, "seek"):
            file.seek(0)
        sr, samples = wavfile.read(file)
        return samples, sr
    except Exception:
        pass
    return _read_via_ffmpeg(file)


def _read_via_ffmpeg(file, target_sr: int = 16000):
    """Decode any container ffmpeg reads to mono int16 at ``target_sr``;
    raises ``ValueError`` where ffmpeg is not installed or fails."""
    if shutil.which("ffmpeg") is None:
        raise ValueError(
            f"cannot decode {file!r}: not a readable WAV and ffmpeg is not "
            f"installed (needed for mp3/flac/opus)")
    if hasattr(file, "read"):
        if hasattr(file, "seek"):
            file.seek(0)
        data = file.read()
        cmd_in = ["-i", "pipe:0"]
    else:
        data = None
        cmd_in = ["-i", str(file)]
    proc = subprocess.run(
        ["ffmpeg", "-loglevel", "quiet"] + cmd_in
        + ["-f", "s16le", "-acodec", "pcm_s16le", "-ac", "1",
           "-ar", str(target_sr), "pipe:1"],
        input=data, capture_output=True)
    if proc.returncode != 0 or not proc.stdout:
        raise ValueError(f"ffmpeg failed to decode {file!r}")
    samples = np.frombuffer(proc.stdout, dtype=np.int16)
    return samples, target_sr
