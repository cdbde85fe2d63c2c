"""Position-wise feed-forward w_2(dropout(act(w_1(x)))) (counterpart of
ppasr_tpu/models/positionwise.py:10-47, without the Squeezeformer scale).
``out_init_scale`` is the depth-scaled init of ``w_2``."""
from torch import nn

from ppasr_tpu_torch.models.base import Dropout, Linear, swish


class PositionwiseFeedForward(nn.Module):
    def __init__(self, idim: int, hidden_units: int, activation=swish,
                 dropout_rate: float = 0.0, out_init_scale: float = 1.0):
        super().__init__()
        self.w_1 = Linear(idim, hidden_units)
        self.w_2 = Linear(hidden_units, idim, init_scale=out_init_scale)
        self.activation = activation
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        return self.w_2(self.dropout(self.activation(self.w_1(x))))
