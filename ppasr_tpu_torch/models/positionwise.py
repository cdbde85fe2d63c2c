"""Position-wise feed-forward w_2(dropout(act(w_1(x)))) (counterpart of
ppasr_tpu/models/positionwise.py:10-47). ``out_init_scale`` is the
depth-scaled init of ``w_2``. The Squeezeformer's options: ``adaptive_scale``
(``ada_scale``·x + ``ada_bias`` on the input, :29-31) and ``init_weights``,
its scale-aware init U(±idim^-0.5) for ``w_1`` and U(±hidden^-0.5) for
``w_2``, biases included. Under tensor parallelism ``tp`` is the mesh: the
input enters the model axis after the adaptive scale, ``w_1`` is a column
shard and ``w_2`` reduces."""
import torch
from torch import nn

from ppasr_tpu_torch.models.base import Dropout, Linear, swish
from ppasr_tpu_torch.parallel.tensor_parallel import copy_to_model


class PositionwiseFeedForward(nn.Module):
    tp = None

    def __init__(self, idim: int, hidden_units: int, activation=swish,
                 dropout_rate: float = 0.0, out_init_scale: float = 1.0,
                 adaptive_scale: bool = False, init_weights: bool = False):
        super().__init__()
        self.w_1 = Linear(idim, hidden_units,
                          init_bound=idim ** -0.5 if init_weights else None)
        self.w_2 = Linear(hidden_units, idim, init_scale=out_init_scale,
                          init_bound=hidden_units ** -0.5 if init_weights
                          else None)
        self.activation = activation
        self.dropout = Dropout(dropout_rate)
        if adaptive_scale:
            self.ada_scale = nn.Parameter(torch.ones(1, 1, idim))
            self.ada_bias = nn.Parameter(torch.zeros(1, 1, idim))
        else:
            self.ada_scale = None

    def forward(self, x):
        if self.ada_scale is not None:
            x = self.ada_scale.to(x.dtype) * x + self.ada_bias.to(x.dtype)
        x = copy_to_model(x, self.tp)
        return self.w_2(self.dropout(self.activation(self.w_1(x))))
