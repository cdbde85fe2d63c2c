"""Shared model plumbing: activations, global CMVN (counterpart of
ppasr_tpu/models/base.py:42-66), and the compute dtype.

The JAX models take a flax ``dtype``: parameters stay float32 and each
Dense, Conv and Embed casts its kernel and input to the dtype, while
LayerNorm computes its statistics, scale and bias in float32 and rounds
its output to the dtype. ``LayerNorm`` below does the same, and
``cast_for_compute`` casts a module's weights once, leaving the LayerNorms
and the CMVN constants in float32. Initializers are not ported: the port
loads trained weights (``utils/checkpoint.convert_params``)."""
import json
import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def swish(x):
    return x * torch.sigmoid(x)


def get_activation(name: str):
    """Activation registry; flax's ``gelu`` is the tanh approximation."""
    acts = {
        "hardtanh": F.hardtanh,
        "tanh": torch.tanh,
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate='tanh'),
        "swish": swish,
    }
    if name not in acts:
        raise ValueError(f"unsupported activation: {name}")
    return acts[name]


def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp.asarray(value, dtype)``
    rounds a constant before it multiplies a tensor of that dtype."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32 with float32 parameters, the
    result in the input's dtype (flax ``LayerNorm(dtype=...)``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class GlobalCMVN(nn.Module):
    """(x - mean) * istd with constants from ``mean_istd.json``; buffers,
    not parameters, and not part of the state dict."""

    def __init__(self, mean, istd):
        super().__init__()
        self.register_buffer('mean', torch.tensor(np.asarray(mean, np.float32)),
                             persistent=False)
        self.register_buffer('istd', torch.tensor(np.asarray(istd, np.float32)),
                             persistent=False)

    def forward(self, x):
        return (x - self.mean) * self.istd


def load_cmvn(mean_istd_path):
    """``mean_istd.json`` → (mean, istd) float32 tuples, as
    ppasr_tpu/models/factory.py:13-29 reads it. A missing file raises:
    a model trained with CMVN mis-predicts without it."""
    if not mean_istd_path:
        return None, None
    if not os.path.exists(mean_istd_path):
        raise FileNotFoundError(f"mean_istd file not found: {mean_istd_path}")
    with open(mean_istd_path, 'r', encoding='utf-8') as f:
        data = json.load(f)
    return (tuple(np.float32(v) for v in data['mean']),
            tuple(np.float32(v) for v in data['istd']))


def cast_for_compute(module: nn.Module, dtype: torch.dtype):
    """Cast the floating parameters and buffers of every submodule to
    ``dtype`` in place, except those of ``LayerNorm`` and ``GlobalCMVN``,
    which stay float32 as flax keeps them."""
    for m in module.modules():
        if isinstance(m, (LayerNorm, GlobalCMVN)):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
        for name, b in m.named_buffers(recurse=False):
            if b.is_floating_point():
                setattr(m, name, b.to(dtype))
    return module
