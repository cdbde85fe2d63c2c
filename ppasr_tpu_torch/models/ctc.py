"""CTC head: the ``ctc_lo`` projection, its loss and its inference heads
(counterpart of ppasr_tpu/models/ctc.py:16-43). The loss is
``ops/ctc.ctc_loss_from_logits`` on the logits in the compute dtype: the
batch's summed negative log-likelihood over B."""
import torch
from torch import nn

from ppasr_tpu_torch.models.base import Dropout, Linear
from ppasr_tpu_torch.ops.ctc import ctc_loss_from_logits


class CTCHead(nn.Module):
    def __init__(self, encoder_dim: int, vocab_size: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.ctc_lo = Linear(encoder_dim, vocab_size)

    def forward(self, encoder_out, encoder_lens, labels, label_lens):
        """The batch-averaged CTC loss."""
        return ctc_loss_from_logits(self.logits(encoder_out), encoder_lens,
                                    labels, label_lens)

    def logits(self, encoder_out):
        return self.ctc_lo(self.dropout(encoder_out))

    def log_softmax(self, encoder_out):
        return torch.log_softmax(self.logits(encoder_out).float(), dim=-1)

    def softmax(self, encoder_out):
        return torch.softmax(self.logits(encoder_out).float(), dim=-1)
