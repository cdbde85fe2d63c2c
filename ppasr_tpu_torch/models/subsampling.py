"""Conv2d subsampling ×4 (counterpart of ppasr_tpu/models/subsampling.py:49-73):
two stride-2 3×3 VALID convs with ReLU, then a linear layer.

The JAX module runs NHWC ([B, T, F, C]) and flattens ``f*c`` with the
feature axis outer (:66-69), so its ``Dense_0.kernel`` rows are in
(f, c) order. Torch convs run NCHW ([B, C, T, F]); the output is permuted
to [B, T, F, C] before flattening so the converted weight applies as is.
The other subsampling layers are not ported yet (ROADMAP Queue A, model
zoo).
"""
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.models.base import Conv2d, Linear


def subsampled_len4(t):
    return (((t - 1) // 2) - 1) // 2


class Conv2dSubsampling4(nn.Module):
    subsampling_rate = 4
    right_context = 6

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.Conv_0 = Conv2d(1, odim, 3, stride=2)
        self.Conv_1 = Conv2d(odim, odim, 3, stride=2)
        f_out = ((idim - 1) // 2 - 1) // 2
        self.Dense_0 = Linear(f_out * odim, odim)

    def forward(self, x):
        """[B, T, F] → [B, T', odim]."""
        x = F.relu(self.Conv_0(x[:, None]))
        x = F.relu(self.Conv_1(x))                  # [B, C, T', F']
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        return self.Dense_0(x)

    @staticmethod
    def out_len(t):
        return subsampled_len4(t)


SUBSAMPLING_CLASSES = {'conv2d': Conv2dSubsampling4}


def subsampling_class(input_layer: str):
    if input_layer not in SUBSAMPLING_CLASSES:
        raise NotImplementedError(
            f"input_layer={input_layer!r} is not ported yet (ROADMAP Queue A "
            f"item 9); the port has {sorted(SUBSAMPLING_CLASSES)}")
    return SUBSAMPLING_CLASSES[input_layer]
