"""Kernel B1, the fused fbank (``ppasr_tpu_torch/csrc/fbank.cu``): the least
time one launch needs on the card, from its shape. The larger of

- the bytes it must move over the memory rate: the samples (and the
  dither's noise, where the launch has one), the 400-point window, each
  filter's band of mel weights and its int32 band entry in, the log-mel
  out;
- the fp32 operations of an FFT-based fbank over the fp32 peak: DC mean,
  pre-emphasis and window (4 a sample), a real 512-point FFT
  (2.5·n·log2 n), the power (3 a bin), the mel projection (2 a weight),
  the floor and the log (2 a filter), and one a sample for the dither.

Same count as the repo's ``chip_smoke.bound_ms``; the band tables are
worked out here from the benchmark's own mel filters."""
import numpy as np

from reference.fbank import mel_weights

N_BINS = 256    # bins the kernel computes; bin 256 has no mel weight


def band_sizes(n_mels: int = 80):
    """(packed mel weights: each filter's run from its first to its last
    non-zero bin below ``N_BINS``, bytes of the [n_mels, 3] int32 band
    table)."""
    w = mel_weights(n_mels)[:, :N_BINS]
    nnz = 0
    for row in w:
        idx = np.flatnonzero(row)
        if idx.size:
            nnz += int(idx[-1]) + 1 - int(idx[0])
    return nnz, n_mels * 3 * 4


def bound_s(n_frames: int, input_samples: int, peaks: dict,
            n_mels: int = 80, noise_floats: int = 0):
    """(seconds, 'operations' or 'bytes', whichever bounds)."""
    nnz, band_bytes = band_sizes(n_mels)
    flops_per_frame = (4 * 400 + 2.5 * 512 * 9 + 3 * 257 + 2 * nnz
                       + 2 * n_mels)
    nbytes = 4 * (input_samples + noise_floats + 400 + nnz
                  + n_frames * n_mels) + band_bytes
    t_bytes = nbytes / peaks['bytes']
    t_ops = (n_frames * flops_per_frame + noise_floats) / peaks['fp32_flops']
    return max(t_bytes, t_ops), ('operations' if t_ops >= t_bytes
                                 else 'bytes')
