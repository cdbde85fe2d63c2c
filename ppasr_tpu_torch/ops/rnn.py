"""A one-layer LSTM or GRU over a whole sequence as one operator,
``ppasr_tpu_torch::rnn``, for programs with a symbolic time axis.

``aten.lstm`` and ``aten.gru`` infer their output shapes by running their
decomposition frame by frame, which fixes the number of frames when
``torch.export`` traces them. This operator runs the same ``torch.lstm`` /
``torch.gru`` call as ``nn.LSTM`` / ``nn.GRU`` (cuDNN on the card), and its
shape function states the shapes without a loop. Importing this module
registers it: a saved program that holds it loads only after the import.
"""
from typing import List, Tuple

import torch


@torch.library.custom_op('ppasr_tpu_torch::rnn', mutates_args=())
def _rnn(x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
         weights: List[torch.Tensor], lstm: bool
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if lstm:
        y, h, c = torch.lstm(x, (h0, c0), weights, True, 1, 0.0, False,
                             False, True)
        return y, h, c
    y, h = torch.gru(x, h0, weights, True, 1, 0.0, False, False, True)
    return y, h, torch.zeros_like(c0)


@_rnn.register_fake
def _(x, h0, c0, weights, lstm):
    b, t, hidden = x.shape[0], x.shape[1], h0.shape[-1]
    return (x.new_empty(b, t, hidden), h0.new_empty(h0.shape),
            c0.new_empty(c0.shape))


def run_rnn(rnn: torch.nn.Module, x: torch.Tensor, carry=None):
    """``rnn(x, carry)`` of a one-layer, batch-first ``nn.LSTM`` or
    ``nn.GRU`` through the operator → (y [B, T, H], carry as ``rnn``
    returns it: (h, c) for the LSTM, h for the GRU)."""
    lstm = isinstance(rnn, torch.nn.LSTM)
    zeros = x.new_zeros(1, x.shape[0], rnn.hidden_size)
    if carry is None:
        h0, c0 = zeros, zeros
    elif lstm:
        h0, c0 = carry
    else:
        h0, c0 = carry, zeros
    y, h, c = _rnn(x, h0, c0, [rnn.weight_ih_l0, rnn.weight_hh_l0,
                               rnn.bias_ih_l0, rnn.bias_hh_l0], lstm)
    return y, ((h, c) if lstm else h)
