"""Plain kaldi log-mel filterbank in float64 numpy: the reference of both
frontends the cells drive (the host featurizer of the streaming engine and
the fused device kernel behind ``predict_batch``).

Frames of 400 samples every 160 (25 ms / 10 ms at 16 kHz, snip edges),
each with its DC removed, pre-emphasis 0.97 with the first sample
repeated, the povey window, a 512-point power spectrum, 80 triangular mel
filters from 20 Hz to Nyquist on kaldi's mel scale, and log(max(·, float32
epsilon)). Input samples are int16-scaled floats.
"""
import functools

import numpy as np

WINDOW = 400
SHIFT = 160
N_FFT = 512
LOG_FLOOR = float(np.finfo(np.float32).eps)


def mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=4)
def mel_weights(n_mels: int = 80, rate: float = 16000.0,
                low: float = 20.0) -> np.ndarray:
    """[n_mels, N_FFT // 2 + 1] triangles; the Nyquist bin has weight 0."""
    high = rate / 2
    lo, hi = mel(low), mel(high)
    delta = (hi - lo) / (n_mels + 1)
    m = np.arange(n_mels)[:, None]
    left, centre, right = lo + m * delta, lo + (m + 1) * delta, \
        lo + (m + 2) * delta
    f = mel(rate / N_FFT * np.arange(N_FFT // 2))[None, :]
    w = np.maximum(0.0, np.minimum((f - left) / (centre - left),
                                   (right - f) / (right - centre)))
    return np.concatenate([w, np.zeros((n_mels, 1))], axis=1)


@functools.lru_cache(maxsize=1)
def povey() -> np.ndarray:
    n = np.arange(WINDOW)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / (WINDOW - 1))) ** 0.85


def n_frames(n_samples: int) -> int:
    return 0 if n_samples < WINDOW else 1 + (n_samples - WINDOW) // SHIFT


def frames_logmel(frames: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """[N, 400] samples → [N, n_mels] float32 log-mel."""
    x = np.asarray(frames, np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    x = x - 0.97 * np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    spec = np.fft.rfft(x * povey()[None, :], n=N_FFT, axis=1)
    power = spec.real ** 2 + spec.imag ** 2
    return np.log(np.maximum(power @ mel_weights(n_mels).T,
                             LOG_FLOOR)).astype(np.float32)


def logmel(samples: np.ndarray, count: int = None,
           n_mels: int = 80) -> np.ndarray:
    """1-D samples → [count, n_mels] log-mel of the first ``count`` frames
    (all whole frames when None)."""
    count = n_frames(len(samples)) if count is None else count
    if count == 0:
        return np.zeros((0, n_mels), np.float32)
    idx = np.arange(count)[:, None] * SHIFT + np.arange(WINDOW)[None, :]
    return frames_logmel(np.asarray(samples)[idx], n_mels)
