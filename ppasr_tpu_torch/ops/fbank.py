"""Kaldi-compatible log-mel fbank: numpy host path and plain torch path.

Counterpart of ppasr_tpu/ops/fbank.py. The numpy functions are copies of
:30-213 there (povey window, DFT basis, mel triangles, snip-edges framing,
``fbank_numpy``, and the ``mfcc_numpy`` and ``linear_numpy`` features with
``dct_matrix`` and ``lifter_coeffs``), used by the host featurizer. The torch functions are the
plain version of the fused fbank kernel (``ops/fbank_cuda.py``,
``csrc/fbank.cu``), which replaces ppasr_tpu/ops/fbank_pallas.py
``_fbank_kernel``:

- ``frame_torch`` is ``frame_jax`` (ppasr_tpu/ops/fbank.py:216-227);
- ``fbank_frames_torch`` computes what ``fbank_frames_pallas`` computes:
  per-frame DC removal over the valid samples, pre-emphasis 0.97 with the
  first sample replicated, povey window, 512-point power spectrum, mel
  projection, ``log(max(mel, 1.19e-7))``;
- ``fbank_batch_torch`` is ``fbank_jax`` (:229-293) at inference: padded
  [B, S] waveforms and their sample counts → ([B, T, M] log-mel, [B] frame
  counts), the plain version of ``fbank_cuda.fbank_batch``.

Precision of the plain version: framing, DC removal, pre-emphasis and window
run in float32 like the kernel; the DFT is ``torch.fft.rfft`` in float64
(a float32 DFT loses the pre-emphasis-suppressed low bins to cancellation,
ppasr_tpu/ops/fbank.py:239-245); the power is cast back to float32 for the
mel projection and the log.
"""
import functools

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07  # float32 eps, kaldi's log floor
MILLISECONDS_TO_SECONDS = 0.001


def next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


@functools.lru_cache(maxsize=8)
def get_mel_banks(num_bins: int, window_length_padded: int, sample_freq: float,
                  low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """[num_bins, window_length_padded // 2 + 1] kaldi mel triangle weights.

    high_freq <= 0 means nyquist + high_freq. The nyquist column is zero
    (kaldi computes bins only up to padded//2 and pads one zero)."""
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not 0.0 <= low_freq < high_freq <= nyquist:
        raise ValueError(f"bad mel band edges {low_freq}, {high_freq}")

    fft_bin_width = sample_freq / window_length_padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1) * mel_delta
    right_mel = mel_low + (bin_idx + 2) * mel_delta

    freqs = fft_bin_width * np.arange(num_fft_bins)[None, :]
    mel = mel_scale(freqs)
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    # zero column for nyquist bin
    weights = np.concatenate(
        [weights, np.zeros((num_bins, 1))], axis=1)
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def povey_window(window_size: int) -> np.ndarray:
    n = np.arange(window_size)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (window_size - 1))
    return (hann ** 0.85).astype(np.float32)


@functools.lru_cache(maxsize=8)
def dft_basis(padded: int) -> tuple:
    """Real/imag DFT matrices [padded, padded//2+1]: the power spectrum is
    (frames @ cos)² + (frames @ sin)²."""
    k = np.arange(padded // 2 + 1)[None, :]
    n = np.arange(padded)[:, None]
    ang = -2.0 * np.pi * n * k / padded
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def num_frames(num_samples: int, sample_rate: int,
               frame_shift_ms: float = 10.0,
               frame_length_ms: float = 25.0) -> int:
    """snip_edges frame count."""
    window_size = int(sample_rate * frame_length_ms * MILLISECONDS_TO_SECONDS)
    window_shift = int(sample_rate * frame_shift_ms * MILLISECONDS_TO_SECONDS)
    if num_samples < window_size:
        return 0
    return 1 + (num_samples - window_size) // window_shift


# ------------------------------------------------------------------ numpy path

def _frame_signal(waveform: np.ndarray, window_size: int,
                  window_shift: int) -> np.ndarray:
    m = 1 + (len(waveform) - window_size) // window_shift
    if m <= 0:
        return np.zeros((0, window_size), np.float32)
    idx = (np.arange(m)[:, None] * window_shift + np.arange(window_size)[None, :])
    return waveform[idx].astype(np.float32)


def _preprocess_frames(frames: np.ndarray, dither: float,
                       remove_dc_offset: bool, preemphasis: float,
                       window: np.ndarray, rng: np.random.Generator = None):
    if dither != 0.0:
        rng = rng or np.random.default_rng()
        frames = frames + dither * rng.standard_normal(frames.shape).astype(np.float32)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * prev
    return frames * window[None, :]


def fbank_numpy(waveform: np.ndarray, sample_rate: int = 16000,
                num_mel_bins: int = 80, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, dither: float = 0.0,
                preemphasis: float = 0.97, remove_dc_offset: bool = True,
                low_freq: float = 20.0, high_freq: float = 0.0,
                use_log_fbank: bool = True,
                rng: np.random.Generator = None) -> np.ndarray:
    """[T, num_mel_bins] kaldi-style log-mel filterbank of a 1-D waveform.

    ``waveform`` must be int16-scaled float (AudioSegment.to('int16'))."""
    window_size = int(sample_rate * frame_length_ms * MILLISECONDS_TO_SECONDS)
    window_shift = int(sample_rate * frame_shift_ms * MILLISECONDS_TO_SECONDS)
    padded = next_power_of_2(window_size)

    frames = _frame_signal(np.asarray(waveform, np.float32), window_size,
                           window_shift)
    if frames.shape[0] == 0:
        return np.zeros((0, num_mel_bins), np.float32)
    frames = _preprocess_frames(frames, dither, remove_dc_offset, preemphasis,
                                povey_window(window_size), rng)
    spec = np.fft.rfft(frames, n=padded, axis=1)
    power = np.abs(spec).astype(np.float32) ** 2
    mel = power @ get_mel_banks(num_mel_bins, padded, float(sample_rate),
                                low_freq, high_freq).T
    if use_log_fbank:
        mel = np.log(np.maximum(mel, EPSILON))
    return mel.astype(np.float32)


@functools.lru_cache(maxsize=8)
def dct_matrix(num_ceps: int, num_mel_bins: int) -> np.ndarray:
    """[num_mel_bins, num_ceps] orthonormal DCT-II basis (kaldi layout)."""
    n = np.arange(num_mel_bins)[:, None]
    k = np.arange(num_ceps)[None, :]
    dct = np.cos(np.pi * k * (2 * n + 1) / (2.0 * num_mel_bins))
    dct *= np.sqrt(2.0 / num_mel_bins)
    dct[:, 0] = 1.0 / np.sqrt(num_mel_bins)
    return dct.astype(np.float32)


@functools.lru_cache(maxsize=8)
def lifter_coeffs(num_ceps: int, cepstral_lifter: float = 22.0) -> np.ndarray:
    i = np.arange(num_ceps)
    return (1.0 + 0.5 * cepstral_lifter * np.sin(np.pi * i / cepstral_lifter)
            ).astype(np.float32)


def mfcc_numpy(waveform: np.ndarray, sample_rate: int = 16000,
               num_mel_bins: int = 80, num_ceps: int = 40,
               frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
               dither: float = 0.0, cepstral_lifter: float = 22.0,
               rng: np.random.Generator = None) -> np.ndarray:
    """[T, num_ceps] kaldi-style MFCC (log-mel → DCT → liftering)."""
    logmel = fbank_numpy(waveform, sample_rate, num_mel_bins,
                         frame_length_ms, frame_shift_ms, dither, rng=rng)
    ceps = logmel @ dct_matrix(num_ceps, num_mel_bins)
    if cepstral_lifter != 0.0:
        ceps = ceps * lifter_coeffs(num_ceps, cepstral_lifter)[None, :]
    return ceps.astype(np.float32)


def linear_numpy(samples: np.ndarray, sample_rate: int,
                 frame_shift_ms: float = 10.0, frame_length_ms: float = 20.0,
                 eps: float = 1e-14) -> np.ndarray:
    """[T, 161] log power spectrogram of float samples in [-1, 1]: hanning
    window, 20 ms / 10 ms at 16 kHz, the one-sided power scaled by the
    window's energy and the rate, bins up to the Nyquist frequency."""
    shift = int(MILLISECONDS_TO_SECONDS * sample_rate * frame_shift_ms)
    size = int(MILLISECONDS_TO_SECONDS * sample_rate * frame_length_ms)
    frames = _frame_signal(np.asarray(samples, np.float32), size, shift)
    if frames.shape[0] == 0:
        return np.zeros((0, size // 2 + 1), np.float32)
    window = np.hanning(size).astype(np.float32)
    spec = np.fft.rfft(frames * window[None, :], axis=1)
    power = np.abs(spec) ** 2
    scale = np.sum(window ** 2) * sample_rate
    power[:, 1:-1] *= 2.0 / scale
    power[:, (0, -1)] /= scale
    freqs = float(sample_rate) / size * np.arange(power.shape[1])
    ind = np.where(freqs <= sample_rate / 2)[0][-1] + 1
    return np.log(power[:, :ind] + eps).astype(np.float32)


# ------------------------------------------------------------------ torch path

def frame_torch(waveform: torch.Tensor, window_size: int, window_shift: int,
                max_frames: int) -> torch.Tensor:
    """[B, S] → [B, max_frames, window_size] strided framing with static
    shape (ppasr_tpu/ops/fbank.py:216-227). Frames past the end of the
    buffer read zeros."""
    s = waveform.shape[-1]
    pad = max(0, (max_frames - 1) * window_shift + window_size - s)
    wav = torch.nn.functional.pad(waveform, (0, pad))
    return wav.unfold(-1, window_size, window_shift)[..., :max_frames, :]


def fbank_frames_torch(frames: torch.Tensor, sample_rate: int = 16000,
                       num_mel_bins: int = 80, preemphasis: float = 0.97,
                       remove_dc_offset: bool = True, low_freq: float = 20.0,
                       high_freq: float = 0.0) -> torch.Tensor:
    """[N, window_size] int16-scaled frames → [N, num_mel_bins] float32
    log-mel on the frames' device. Plain version of the fbank kernel."""
    window_size = frames.shape[-1]
    padded = next_power_of_2(window_size)
    dev = frames.device
    x = frames.to(torch.float32)
    if remove_dc_offset:
        x = x - x.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - preemphasis * prev
    x = x * torch.from_numpy(povey_window(window_size)).to(dev)
    spec = torch.fft.rfft(x.to(torch.float64), n=padded, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2).to(torch.float32)
    mel_w = torch.from_numpy(get_mel_banks(
        num_mel_bins, padded, float(sample_rate), low_freq, high_freq)).to(dev)
    mel = power @ mel_w.T
    return torch.log(torch.clamp(mel, min=EPSILON))


def batch_frame_lens(lengths: torch.Tensor, max_t: int,
                     window_size: int = 400,
                     window_shift: int = 160) -> torch.Tensor:
    """[B] sample counts → [B] int32 snip-edges frame counts, capped at the
    batch's static frame capacity ``max_t`` (ppasr_tpu/ops/fbank.py:289-292)."""
    lengths = lengths.to(torch.int32)
    frame_lens = torch.where(lengths >= window_size,
                             1 + (lengths - window_size) // window_shift, 0)
    return torch.clamp(frame_lens, max=max_t).to(torch.int32)


def fbank_batch_torch(waveform: torch.Tensor, lengths: torch.Tensor,
                      sample_rate: int = 16000, num_mel_bins: int = 80,
                      noise: torch.Tensor = None, **kw):
    """[B, S] int16-scaled waveforms + [B] sample counts → ([B, T, M]
    float32 log-mel, [B] int32 frame counts) with the static frame capacity
    T = 1 + (S − 400) // 160 (0 below 400 samples). Frames that run into a
    row's padding are computed; callers mask them by the frame counts.
    ``noise`` [B, T, 400]: the training dither, added to the framed samples
    before the DC removal (ppasr_tpu/ops/fbank.py:262-264)."""
    bsz, s = waveform.shape
    max_t = max(1 + (s - 400) // 160, 0)
    frame_lens = batch_frame_lens(lengths, max_t)
    if max_t == 0:
        return (waveform.new_zeros((bsz, 0, num_mel_bins), dtype=torch.float32),
                frame_lens)
    frames = frame_torch(waveform.to(torch.float32), 400, 160, max_t)
    if noise is not None:
        frames = frames + noise
    return fbank_frames_torch(frames, sample_rate, num_mel_bins,
                              **kw), frame_lens
