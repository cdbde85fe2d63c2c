"""Input layers (counterpart of ppasr_tpu/models/subsampling.py:21-135):

- ``LinearNoSubsampling`` (:29-46): Dense → LayerNorm (eps 1e-12) →
  dropout → ReLU, no time reduction;
- ``Conv2dSubsampling4`` (:49-73): two stride-2 3×3 VALID convs with ReLU,
  then a linear layer, ×4 in time;
- ``Conv2dSubsampling6`` (:76-100): a 3×3 stride-2 and a 5×5 stride-3
  VALID conv, ×6;
- ``Conv2dSubsampling8`` (:103-125): three stride-2 3×3 VALID convs, ×8.

The JAX modules run NHWC ([B, T, F, C]) and flatten ``f*c`` with the
feature axis outer, so their ``Dense_0.kernel`` rows are in (f, c) order.
Torch convs run NCHW ([B, C, T, F]); the output is permuted to
[B, T, F, C] before flattening so the converted weight applies as is.
"""
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.models.base import Conv2d, Dropout, LayerNorm, Linear


def subsampled_len4(t):
    return (((t - 1) // 2) - 1) // 2


def subsampled_len6(t):
    return (((t - 1) // 2) - 2) // 3


def subsampled_len8(t):
    return ((((t - 1) // 2 - 1) // 2) - 1) // 2


def flatten_nhwc(x):
    """[B, C, T, F] → [B, T, F·C], feature axis outer (flax's reshape)."""
    b, c, t, f = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, t, f * c)


class LinearNoSubsampling(nn.Module):
    subsampling_rate = 1
    right_context = 0

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.Dense_0 = Linear(idim, odim)
        self.LayerNorm_0 = LayerNorm(odim, eps=1e-12)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        return F.relu(self.dropout(self.LayerNorm_0(self.Dense_0(x))))

    @staticmethod
    def out_len(t):
        return t


class _ConvSubsampling(nn.Module):
    """VALID convs with ReLU (``CONVS``, each (kernel, stride)), then
    ``Dense_0`` over the flattened (f, c) features."""
    CONVS = ()

    def __init__(self, idim: int, odim: int):
        super().__init__()
        f = idim
        for i, (k, s) in enumerate(self.CONVS):      # flax's Conv_<i> names
            self.add_module(f'Conv_{i}', Conv2d(1 if i == 0 else odim, odim,
                                                k, stride=s))
            f = (f - k) // s + 1
        self.n_convs = len(self.CONVS)
        self.Dense_0 = Linear(f * odim, odim)

    def forward(self, x):
        """[B, T, F] → [B, T', odim]."""
        x = x[:, None]
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f'Conv_{i}')(x))
        return self.Dense_0(flatten_nhwc(x))


class Conv2dSubsampling4(_ConvSubsampling):
    CONVS = ((3, 2), (3, 2))
    subsampling_rate = 4
    right_context = 6
    out_len = staticmethod(subsampled_len4)


class Conv2dSubsampling6(_ConvSubsampling):
    CONVS = ((3, 2), (5, 3))
    subsampling_rate = 6
    right_context = 10
    out_len = staticmethod(subsampled_len6)


class Conv2dSubsampling8(_ConvSubsampling):
    CONVS = ((3, 2), (3, 2), (3, 2))
    subsampling_rate = 8
    right_context = 14
    out_len = staticmethod(subsampled_len8)


SUBSAMPLING_CLASSES = {
    'linear': LinearNoSubsampling,
    'conv2d': Conv2dSubsampling4,
    'conv2d6': Conv2dSubsampling6,
    'conv2d8': Conv2dSubsampling8,
}


def subsampling_class(input_layer: str):
    if input_layer not in SUBSAMPLING_CLASSES:
        raise ValueError(f"unknown input_layer {input_layer!r}; one of "
                         f"{sorted(SUBSAMPLING_CLASSES)}")
    return SUBSAMPLING_CLASSES[input_layer]
