"""Host feature augmentors on [T, D] numpy features (copy of
ppasr_tpu/data/augmentor/feature_augmentors.py:19-85), drawing from
Python's ``random`` as the JAX package's do, so the same seed gives the
same features bit for bit:

- ``SpecAugmentor``: a time warp of ±``max_time_warp`` frames around a
  random centre (numpy linear interpolation), ``n_freq_masks`` frequency
  masks of at most ``max_f_ratio``·D bins and ``n_time_masks`` time masks
  of at most ``max_t_ratio``·T frames, filled with the feature mean (or
  zero with ``replace_with_zero``);
- ``SpecSubAugmentor``: ``num_t_sub`` times, a span of up to ``max_t``
  frames replaced by an earlier span of the same width.

Training with the device frontend runs the same stages on the card
(``ops/frontend``); these run on host features.
"""
import random

import numpy as np

from ppasr_tpu_torch.data.augmentor.base import AugmentorBase


class SpecAugmentor(AugmentorBase):
    def __init__(self, inplace=True, max_time_warp=5, max_t_ratio=0.05,
                 n_freq_masks=2, max_f_ratio=0.15, n_time_masks=2,
                 replace_with_zero=False):
        self.inplace = inplace
        self.max_time_warp = max_time_warp
        self.max_t_ratio = max_t_ratio
        self.n_freq_masks = n_freq_masks
        self.max_f_ratio = max_f_ratio
        self.n_time_masks = n_time_masks
        self.replace_with_zero = replace_with_zero

    def _time_warp(self, x: np.ndarray) -> np.ndarray:
        """Warp the time axis around a random center by ±w frames via linear
        interpolation (the reference stretches the two halves with PIL
        BICUBIC resize; linear interp has the same effect on features)."""
        t = x.shape[0]
        w = self.max_time_warp
        if w == 0 or t - w <= w:
            return x
        center = random.randrange(w, t - w)
        warped = center + random.randrange(-w, w + 1)
        warped = int(np.clip(warped, 1, t - 1))
        src_left = np.linspace(0, center, warped, endpoint=False)
        src_right = np.linspace(center, t - 1, t - warped)
        src = np.concatenate([src_left, src_right])
        idx0 = np.floor(src).astype(np.int64)
        idx1 = np.minimum(idx0 + 1, t - 1)
        frac = (src - idx0)[:, None].astype(x.dtype)
        return x[idx0] * (1 - frac) + x[idx1] * frac

    def transform_feature(self, feature: np.ndarray) -> np.ndarray:
        x = feature if self.inplace else feature.copy()
        x = self._time_warp(x)
        t, d = x.shape
        fill = 0.0 if self.replace_with_zero else float(x.mean())
        max_f = int(d * self.max_f_ratio)
        for _ in range(self.n_freq_masks):
            width = random.randrange(0, max_f + 1)
            start = random.randrange(0, max(d - width, 1))
            x[:, start:start + width] = fill
        max_t = int(t * self.max_t_ratio)
        for _ in range(self.n_time_masks):
            width = random.randrange(0, max_t + 1)
            start = random.randrange(0, max(t - width, 1))
            x[start:start + width, :] = fill
        return x


class SpecSubAugmentor(AugmentorBase):
    def __init__(self, max_t=30, num_t_sub=3):
        self.max_t = max_t
        self.num_t_sub = num_t_sub

    def transform_feature(self, feature: np.ndarray) -> np.ndarray:
        x = feature.copy()
        t = x.shape[0]
        for _ in range(self.num_t_sub):
            if t < 2:
                break
            start = random.randrange(0, t)
            length = random.randrange(1, self.max_t + 1)
            end = min(t, start + length)
            # copy an earlier window of the same width over [start, end)
            pos = random.randrange(0, start + 1) if start > 0 else 0
            x[start:end, :] = feature[start - pos:end - pos, :]
        return x
