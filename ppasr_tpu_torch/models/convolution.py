"""Conformer convolution module: pointwise → GLU → depthwise → LayerNorm →
activation → pointwise (counterpart of ppasr_tpu/models/convolution.py:
19-105).

Causal mode left-pads the module input by kernel−1 frames: zeros on the
first chunk, the ``cnn_cache`` of raw input frames after it; the new cache
is the last kernel−1 padded input frames. Non-causal mode pads the
depthwise conv as flax's ``SAME``. Pad positions are zeroed with the batch
mask before and after. Data stays [B, T, C]; the depthwise conv runs on
[B, C, T]. Batch norm in the module comes with the model zoo (ROADMAP
Queue A). ``out_init_scale`` is the depth-scaled init of
``pointwise_conv2``.
"""
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.models.base import Conv1d, LayerNorm, Linear, swish


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 15,
                 activation=swish, norm: str = 'layer_norm',
                 causal: bool = False, out_init_scale: float = 1.0):
        super().__init__()
        if norm != 'layer_norm':
            raise NotImplementedError(
                f"cnn_module_norm={norm!r} is not ported yet (ROADMAP Queue A, "
                f"model zoo)")
        self.kernel_size = kernel_size
        self.causal = causal
        self.lorder = kernel_size - 1 if causal else 0
        self.activation = activation
        self.pointwise_conv1 = Linear(channels, 2 * channels)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size,
                                     groups=channels)
        self.norm = LayerNorm(channels, eps=1e-5)
        self.pointwise_conv2 = Linear(channels, channels,
                                      init_scale=out_init_scale)

    def forward(self, x, mask_pad=None, cache=None):
        """x [B, T, C]; mask_pad [B, 1, T] bool (True = valid); cache
        [B, lorder, C]. Returns (y [B, T, C], new_cache [B, lorder, C])."""
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        if self.causal:
            pad = cache if cache is not None else x.new_zeros(
                x.shape[0], self.lorder, x.shape[2])
            x = torch.cat([pad, x], dim=1)
            new_cache = x[:, -self.lorder:, :]
        else:
            new_cache = x.new_zeros(x.shape[0], 0, x.shape[2])

        y = self.pointwise_conv1(x)
        a, b = y.chunk(2, dim=-1)
        y = (a * torch.sigmoid(b)).transpose(1, 2)      # [B, C, T+lorder]
        if not self.causal:
            total = self.kernel_size - 1
            y = F.pad(y, (total // 2, total - total // 2))
        y = self.depthwise_conv(y).transpose(1, 2)
        y = self.pointwise_conv2(self.activation(self.norm(y)))
        if mask_pad is not None:
            y = y.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        return y, new_cache
