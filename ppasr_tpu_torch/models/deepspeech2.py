"""DeepSpeech2: conv subsampling ×4, a stack of LSTM or GRU layers and a
CTC head (counterpart of ppasr_tpu/models/deepspeech2.py:26-183).

- ``Conv2dSubsampling4Pure`` (:32-52): two stride-2 3×3 VALID convs of 32
  channels with ReLU, flattened (f, c) with no projection.
- ``CRNNEncoder`` (:55-126): per layer one LSTM or GRU (``fwd_rnns``;
  ``models/base.LSTM``/``GRU``, which cast their weights at use under
  ``cast_at_use``, so ``enable_amp`` trains the cells in bf16 over float32
  weights as the flax cells with ``dtype=bf16`` do), and when not
  streaming a second one over the reversed sequence (``bwd_rnns``), their
  outputs concatenated; a LayerNorm (eps 1e-6, flax's default) after each
  layer. The input, the carry (``init_state``) and the outputs are in the
  compute dtype.
- ``DeepSpeech2Model`` (:129-183): the CTC loss alone (``loss_att`` and
  ``th_accuracy`` None), ``get_encoder_out``, ``get_encoder_logits``,
  ``get_ctc_log_probs`` and the streaming ``get_encoder_out_chunk`` with
  ``lens`` and the (h, c) state ``DS2State``, which ``stream_step`` calls.

Each row runs through its first ``min(out_len, T')`` frames
(``pack_padded_sequence``), as flax's ``nn.RNN(seq_lengths=...)`` does:
the state returned is the state after the row's last valid frame, and the
backward direction reverses only the valid prefix (flax's
``keep_order=True``). Outputs past a row's length are zero before the
LayerNorm, where flax's are the cell's; no valid output depends on them.
A row of length 0 (a padding row of a batch) runs one frame. The flax
cells and torch's compute the same gates: converted weights apply as
``utils/checkpoint._rnn_from_cell`` packs them. Torch has two biases where
a flax cell has one (the LSTM's input and hidden biases, the GRU's r and z
biases on both sides): the second one is held at zero, the LSTM's
``bias_ih`` out of training and the GRU's ``bias_hh`` r and z rows with
their gradient zeroed, so the trained parameters, their gradient norm and
the optimizer's steps are flax's.
"""
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ppasr_tpu_torch.models.base import (GRU, LSTM, ASRModel, Conv2d,
                                         GlobalCMVN, LayerNorm,
                                         compute_dtype_of)
from ppasr_tpu_torch.models.ctc import CTCHead
from ppasr_tpu_torch.models.subsampling import flatten_nhwc
from ppasr_tpu_torch.ops.rnn import run_rnn


class DS2State(NamedTuple):
    """Streaming RNN state: h and c, each [num_layers, B, rnn_size] (c is
    zero for the GRU)."""
    h: torch.Tensor
    c: torch.Tensor

    def stream_axes(self):
        return DS2State(1, 1)


class Conv2dSubsampling4Pure(nn.Module):
    subsampling_rate = 4

    def __init__(self, odim: int = 32):
        super().__init__()
        self.Conv_0 = Conv2d(1, odim, 3, stride=2)
        self.Conv_1 = Conv2d(odim, odim, 3, stride=2)

    def forward(self, x):
        x = F.relu(self.Conv_0(x[:, None]))
        return flatten_nhwc(F.relu(self.Conv_1(x)))

    @staticmethod
    def out_len(lens):
        return ((lens - 1) // 2 - 1) // 2


def _hold_second_bias(rnn: nn.Module):
    """Keep the bias that flax's cell lacks at zero under training."""
    if isinstance(rnn, nn.LSTM):
        rnn.bias_ih_l0.requires_grad_(False)
        return
    h = rnn.hidden_size
    rnn.bias_hh_l0.register_hook(
        lambda g: torch.cat([torch.zeros_like(g[:2 * h]), g[2 * h:]]))


def _reverse_prefix(x, lens):
    """Each row's first ``lens`` frames reversed in place, the rest kept."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    idx = torch.where(t < lens[:, None], lens[:, None] - 1 - t, t)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


class CRNNEncoder(nn.Module):
    unpacked = False     # see ``_run``
    def __init__(self, input_dim: int, num_rnn_layers: int = 5,
                 rnn_size: int = 1024, use_gru: bool = False,
                 bidirectional: bool = False,
                 cmvn_mean: Optional[tuple] = None,
                 cmvn_istd: Optional[tuple] = None):
        super().__init__()
        self.num_rnn_layers, self.rnn_size = num_rnn_layers, rnn_size
        self.use_gru, self.bidirectional = use_gru, bidirectional
        self.global_cmvn = (GlobalCMVN(cmvn_mean, cmvn_istd)
                            if cmvn_mean is not None else None)
        self.conv = Conv2dSubsampling4Pure(32)
        rnn = GRU if use_gru else LSTM
        dim = ((input_dim - 1) // 2 - 1) // 2 * 32
        self.fwd_rnns, self.bwd_rnns = nn.ModuleList(), nn.ModuleList()
        for _ in range(num_rnn_layers):
            self.fwd_rnns.append(rnn(dim, rnn_size, batch_first=True))
            if bidirectional:
                self.bwd_rnns.append(rnn(dim, rnn_size, batch_first=True))
            dim = self.output_size
        for m in list(self.fwd_rnns) + list(self.bwd_rnns):
            _hold_second_bias(m)
        self.norms = nn.ModuleList([LayerNorm(self.output_size, eps=1e-6)
                                    for _ in range(num_rnn_layers)])

    def train(self, mode: bool = True):
        """Train or eval mode, the RNNs always in training mode: for one
        layer without dropout the flag changes nothing in their output,
        and cuDNN runs an RNN's backward only in training mode (the train
        step's deterministic parity checks run in eval mode)."""
        super().train(mode)
        for m in list(self.fwd_rnns) + list(self.bwd_rnns):
            m.train(True)
        return self

    @property
    def output_size(self):
        return 2 * self.rnn_size if self.bidirectional else self.rnn_size

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype_of(self.conv.Conv_0)

    def _run(self, rnn, x, lens, carry=None):
        """(outputs [B, T, H] zero past each length, final carry). With
        ``unpacked`` set (``infer_utils/torch_export``, where the lengths
        are not host integers) every row runs all T frames and its outputs
        past its length are zeroed: the outputs are the packed run's, the
        carry the one after frame T (the packed run's when every length is
        T, as in the exported chunk step)."""
        if self.unpacked:
            y, carry = run_rnn(rnn, x, carry)
            valid = torch.arange(x.shape[1], device=x.device)[None, :] \
                < lens[:, None]
            return y * valid[..., None].to(y.dtype), carry
        packed = pack_padded_sequence(x, lens.cpu(), batch_first=True,
                                      enforce_sorted=False)
        y, carry = rnn(packed, carry)
        y, _ = pad_packed_sequence(y, batch_first=True,
                                   total_length=x.shape[1])
        return y, carry

    def forward(self, x, x_lens, state: Optional[DS2State] = None):
        """x [B, T, D] features, x_lens [B] → (out [B, T', D'], out_lens
        [B], new_state)."""
        if self.global_cmvn is not None:
            x = self.global_cmvn(x)
        x = self.conv(x.to(self.dtype))
        out_lens = Conv2dSubsampling4Pure.out_len(x_lens.to(torch.int32))
        seq_lens = out_lens.clamp(1, x.shape[1])
        new_h, new_c = [], []
        for i in range(self.num_rnn_layers):
            carry = None
            if state is not None:
                carry = state.h[i][None] if self.use_gru else \
                    (state.h[i][None], state.c[i][None])
            y, carry = self._run(self.fwd_rnns[i], x, seq_lens, carry)
            if self.use_gru:
                new_h.append(carry[0])
                new_c.append(torch.zeros_like(carry[0]))
            else:
                new_h.append(carry[0][0])
                new_c.append(carry[1][0])
            if self.bidirectional:
                y_b, _ = self._run(self.bwd_rnns[i],
                                   _reverse_prefix(x, seq_lens), seq_lens)
                y = torch.cat([y, _reverse_prefix(y_b, seq_lens)], dim=-1)
            x = self.norms[i](y)
        return x, out_lens, DS2State(h=torch.stack(new_h),
                                     c=torch.stack(new_c))

    def init_state(self, batch_size: int, device=None) -> DS2State:
        shape = (self.num_rnn_layers, batch_size, self.rnn_size)
        z = torch.zeros(shape, dtype=self.dtype, device=device)
        return DS2State(h=z, c=z.clone())


class DeepSpeech2Model(ASRModel):
    subsampling_rate = 4
    right_context = 6
    ring_cache = False

    def __init__(self, input_size: int, vocab_size: int,
                 streaming: bool = True, encoder_conf: Optional[dict] = None,
                 decoder_conf: Optional[dict] = None,
                 cmvn_mean: Optional[tuple] = None,
                 cmvn_istd: Optional[tuple] = None):
        super().__init__()
        conf = dict(encoder_conf or {})
        conf.pop('rnn_direction', None)
        self.streaming = streaming
        self.vocab_size = vocab_size
        self.encoder = CRNNEncoder(input_size, bidirectional=not streaming,
                                   cmvn_mean=cmvn_mean, cmvn_istd=cmvn_istd,
                                   **conf)
        self.ctc = CTCHead(self.encoder.output_size, vocab_size,
                           **dict(decoder_conf or {}))

    def forward(self, speech, speech_lens, text, text_lens, rngs=None):
        """The CTC training loss → {loss, loss_ctc, loss_att: None,
        th_accuracy: None}; ``rngs`` is accepted and unused (no dropout or
        chunk in the model)."""
        eouts, eouts_len, _ = self.encoder(speech, speech_lens)
        loss = self.ctc(eouts, eouts_len, text, text_lens)
        return {'loss': loss, 'loss_ctc': loss, 'loss_att': None,
                'th_accuracy': None}

    def get_encoder_out(self, speech, speech_lens):
        eouts, eouts_len, _ = self.encoder(speech, speech_lens)
        return self.ctc.softmax(eouts), eouts_len

    def get_ctc_log_probs(self, speech, speech_lens):
        eouts, eouts_len, _ = self.encoder(speech, speech_lens)
        return self.ctc.log_softmax(eouts), eouts_len

    def get_encoder_logits(self, speech, speech_lens):
        eouts, eouts_len, _ = self.encoder(speech, speech_lens)
        return self.ctc.logits(eouts), eouts_len

    def get_encoder_out_chunk(self, speech, speech_lens, state: DS2State):
        """One streaming step → (probs [B, T', V], out_lens [B],
        new_state)."""
        eouts, eouts_len, new_state = self.encoder(speech, speech_lens, state)
        return self.ctc.softmax(eouts), eouts_len, new_state

    def stream_step(self, xs, frames: int, state, keep_encoder=False):
        """``ConformerModel.stream_step`` for the RNNs: every row runs
        ``frames`` frames; no attention decoder, so no encoder output."""
        lens = torch.full((xs.shape[0],), frames, device=xs.device)
        probs, _, new_state = self.get_encoder_out_chunk(xs, lens, state)
        return probs, None, new_state

    def init_state(self, batch_size: int, cache_size: int = 0,
                   device=None) -> DS2State:
        """Zero (h, c); ``cache_size`` is accepted and unused, as in the
        JAX model (:172-178)."""
        return self.encoder.init_state(batch_size, device)
