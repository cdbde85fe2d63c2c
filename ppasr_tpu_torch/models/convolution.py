"""Conformer convolution module: pointwise → GLU → depthwise → norm →
activation → pointwise (counterpart of ppasr_tpu/models/convolution.py:
19-105).

Causal mode left-pads the module input by kernel−1 frames: zeros on the
first chunk, the ``cnn_cache`` of raw input frames after it; the new cache
is the last kernel−1 padded input frames. Non-causal mode pads the
depthwise conv as flax's ``SAME``. Pad positions are zeroed with the batch
mask before and after. Data stays [B, T, C]; the depthwise conv runs on
[B, C, T]. ``norm`` is ``'layer_norm'`` or ``'batch_norm'`` (flax's
``BatchNorm``, ``models/base.BatchNorm``). ``out_init_scale`` is the
depth-scaled init of ``pointwise_conv2``.

The Squeezeformer's options (:44-50): ``adaptive_scale`` multiplies the
module input by ``ada_scale`` and adds ``ada_bias`` ([1, 1, C] each);
``init_weights`` is its scale-aware init, U(±channels^-0.5) for the
pointwise convs and U(±kernel^-0.5) for the depthwise one, biases
included.

Under tensor parallelism ``tp`` is the mesh and the module computes its
rank's channel slice: ``pointwise_conv1`` holds the rank's slice of each
GLU half, the depthwise conv and the norm its channels (the LayerNorm's
statistics over the whole vector), and ``pointwise_conv2`` reduces. The
causal cache stays the whole module input.
"""
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.models.base import (BatchNorm, Conv1d, LayerNorm, Linear,
                                         swish)
from ppasr_tpu_torch.parallel.tensor_parallel import copy_to_model


def make_norm(norm: str, channels: int):
    """The conv module's ``norm``: LayerNorm or BatchNorm, eps 1e-5."""
    if norm == 'layer_norm':
        return LayerNorm(channels, eps=1e-5)
    if norm == 'batch_norm':
        return BatchNorm(channels, eps=1e-5)
    raise ValueError(f"unknown cnn module norm {norm!r}")


class ConvolutionModule(nn.Module):
    tp = None

    def __init__(self, channels: int, kernel_size: int = 15,
                 activation=swish, norm: str = 'layer_norm',
                 causal: bool = False, out_init_scale: float = 1.0,
                 adaptive_scale: bool = False, init_weights: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.causal = causal
        self.lorder = kernel_size - 1 if causal else 0
        self.activation = activation
        pw = channels ** -0.5 if init_weights else None
        dw = kernel_size ** -0.5 if init_weights else None
        self.pointwise_conv1 = Linear(channels, 2 * channels, init_bound=pw)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size,
                                     groups=channels, init_bound=dw)
        self.norm = make_norm(norm, channels)
        self.pointwise_conv2 = Linear(channels, channels,
                                      init_scale=out_init_scale,
                                      init_bound=pw)
        if adaptive_scale:
            self.ada_scale = nn.Parameter(torch.ones(1, 1, channels))
            self.ada_bias = nn.Parameter(torch.zeros(1, 1, channels))
        else:
            self.ada_scale = None

    def forward(self, x, mask_pad=None, cache=None):
        """x [B, T, C]; mask_pad [B, 1, T] bool (True = valid); cache
        [B, lorder, C]. Returns (y [B, T, C], new_cache [B, lorder, C])."""
        if self.ada_scale is not None:
            x = self.ada_scale.to(x.dtype) * x + self.ada_bias.to(x.dtype)
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        if self.causal:
            pad = cache if cache is not None else x.new_zeros(
                x.shape[0], self.lorder, x.shape[2])
            x = torch.cat([pad, x], dim=1)
            new_cache = x[:, x.shape[1] - self.lorder:, :]
        else:
            new_cache = x.new_zeros(x.shape[0], 0, x.shape[2])

        y = self.pointwise_conv1(copy_to_model(x, self.tp))
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
