"""Conformer model, encoder and CTC head (counterpart of
ppasr_tpu/models/conformer.py:29-204 for inference).

``streaming=True`` makes the encoder dynamic-chunk and causal (:52-55).
Entry points: ``get_encoder_out`` (full context, :114-120),
``get_encoder_logits`` (full context, CTC logits with no softmax, :128-136),
``get_encoder_out_chunk`` (one streaming step, :157-162) and ``init_state``
(:172-190). The attention decoder and the training loss come with later
work (ROADMAP Queue A, attention rescoring and training); their config
sections are accepted and ignored.
"""
from typing import Optional

import torch
from torch import nn

from ppasr_tpu_torch.models.conformer_encoder import (ConformerEncoder,
                                                      StreamingState)
from ppasr_tpu_torch.models.ctc import CTCHead


class ConformerModel(nn.Module):
    def __init__(self, input_size: int, vocab_size: int,
                 streaming: bool = True, encoder_conf: Optional[dict] = None,
                 decoder_conf: Optional[dict] = None, ctc_weight: float = 0.3,
                 lsm_weight: float = 0.1, reverse_weight: float = 0.3,
                 length_normalized_loss: bool = False,
                 cmvn_mean: Optional[tuple] = None,
                 cmvn_istd: Optional[tuple] = None):
        super().__init__()
        conf = dict(encoder_conf or {})
        if streaming:
            conf['use_dynamic_chunk'] = True
            conf['causal'] = True
        self.streaming = streaming
        self.vocab_size = vocab_size
        self.encoder = ConformerEncoder(input_size, cmvn_mean=cmvn_mean,
                                        cmvn_istd=cmvn_istd, **conf)
        self.ctc = CTCHead(self.encoder.output_size, vocab_size)

    @property
    def subsampling_rate(self):
        return self.encoder.subsampling_rate

    @property
    def right_context(self):
        return self.encoder.right_context

    def _encode_full(self, speech, speech_lens):
        return self.encoder(speech, speech_lens,
                            decoding_chunk_size=-1 if self.streaming else 0)

    def get_encoder_out(self, speech, speech_lens):
        """Full-context CTC softmax → (probs [B, T', V] float32, out_lens [B])."""
        encoder_out, encoder_mask = self._encode_full(speech, speech_lens)
        probs = self.ctc.softmax(encoder_out)
        return probs, encoder_mask[:, 0, :].sum(dim=-1).to(torch.int32)

    def get_encoder_logits(self, speech, speech_lens):
        """Full-context CTC logits with no softmax → (logits [B, T', V],
        out_lens [B]), for the beam search's softmax-free batch path."""
        encoder_out, encoder_mask = self._encode_full(speech, speech_lens)
        logits = self.ctc.logits(encoder_out)
        return logits, encoder_mask[:, 0, :].sum(dim=-1).to(torch.int32)

    def get_ctc_log_probs(self, speech, speech_lens):
        encoder_out, encoder_mask = self._encode_full(speech, speech_lens)
        log_probs = self.ctc.log_softmax(encoder_out)
        return log_probs, encoder_mask[:, 0, :].sum(dim=-1).to(torch.int32)

    def get_encoder_out_chunk(self, xs, state: StreamingState):
        """One streaming chunk step → (probs [B, T_out, V], new_state)."""
        encoder_out, new_state = self.encoder.forward_chunk(xs, state)
        return self.ctc.softmax(encoder_out), new_state

    def init_state(self, batch_size: int, cache_size: int,
                   device=None) -> StreamingState:
        return self.encoder.init_state(batch_size, cache_size, device)
