"""Conformer model: encoder, CTC head and attention decoder (counterpart of
ppasr_tpu/models/conformer.py:29-204 for inference).

``streaming=True`` makes the encoder dynamic-chunk and causal (:52-55).
Entry points: ``get_encoder_out`` (full context, :114-120),
``get_encoder_logits`` (full context, CTC logits with no softmax, :128-136),
``encode_for_rescore`` (the encoder output beside the CTC posteriors,
:138-145), ``attention_rescore_scores`` (the decoder's scores of beam
hypotheses, :147-155), ``get_encoder_out_chunk`` (one streaming step,
:157-162), ``get_encoder_out_chunk_rescore`` (the same step, also returning
the encoder output, :164-170) and ``init_state`` (:172-190).

The attention decoder exists where the JAX model has its parameters: when
``ctc_weight < 1`` (the training loss calls it only then); its R2L half when
``r_num_blocks > 0``. ``set_compute_dtype`` is the flax ``dtype``
(``models/base.cast_for_compute``): CTC posteriors and the decoder's scores
stay float32. The training loss comes with training support (ROADMAP Queue
A, training).
"""
from typing import Optional

import torch
from torch import nn

from ppasr_tpu_torch.models.base import cast_for_compute
from ppasr_tpu_torch.models.conformer_encoder import (ConformerEncoder,
                                                      StreamingState)
from ppasr_tpu_torch.models.ctc import CTCHead
from ppasr_tpu_torch.models.rescore import attention_rescore_scores
from ppasr_tpu_torch.models.transformer_decoder import BiTransformerDecoder


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
        self.reverse_weight = reverse_weight
        self.sos = self.eos = vocab_size - 1
        self.encoder = ConformerEncoder(input_size, cmvn_mean=cmvn_mean,
                                        cmvn_istd=cmvn_istd, **conf)
        self.decoder = (BiTransformerDecoder(
            vocab_size, self.encoder.output_size, **dict(decoder_conf or {}))
            if ctc_weight < 1.0 else None)
        self.ctc = CTCHead(self.encoder.output_size, vocab_size)

    @property
    def subsampling_rate(self):
        return self.encoder.subsampling_rate

    @property
    def right_context(self):
        return self.encoder.right_context

    def set_compute_dtype(self, dtype: torch.dtype):
        """Run in ``dtype`` from now on (the JAX model's ``dtype``)."""
        cast_for_compute(self, dtype)
        return self

    def _encode_full(self, speech, speech_lens):
        return self.encoder(speech, speech_lens,
                            decoding_chunk_size=-1 if self.streaming else 0)

    @staticmethod
    def _lens(encoder_mask):
        return encoder_mask[:, 0, :].sum(dim=-1).to(torch.int32)

    def get_encoder_out(self, speech, speech_lens):
        """Full-context CTC softmax → (probs [B, T', V] float32, out_lens [B])."""
        encoder_out, encoder_mask = self._encode_full(speech, speech_lens)
        return self.ctc.softmax(encoder_out), self._lens(encoder_mask)

    def get_encoder_logits(self, speech, speech_lens):
        """Full-context CTC logits with no softmax, in the compute dtype →
        (logits [B, T', V], out_lens [B]), for the beam search's
        softmax-free batch path."""
        encoder_out, encoder_mask = self._encode_full(speech, speech_lens)
        return self.ctc.logits(encoder_out), self._lens(encoder_mask)

    def get_ctc_log_probs(self, speech, speech_lens):
        encoder_out, encoder_mask = self._encode_full(speech, speech_lens)
        return self.ctc.log_softmax(encoder_out), self._lens(encoder_mask)

    def encode_for_rescore(self, speech, speech_lens):
        """One full-context forward → (encoder_out [B, T', D], probs
        [B, T', V] float32, out_lens [B])."""
        encoder_out, encoder_mask = self._encode_full(speech, speech_lens)
        return (encoder_out, self.ctc.softmax(encoder_out),
                self._lens(encoder_mask))

    def attention_rescore_scores(self, encoder_out, encoder_lens, hyps,
                                 hyps_lens):
        """[B, K] float32 attention log-prob scores of beam hypotheses
        (``models/rescore.attention_rescore_scores``)."""
        if self.decoder is None:
            raise ValueError("the model has no attention decoder "
                             "(ctc_weight is 1)")
        return attention_rescore_scores(self.decoder, encoder_out,
                                        encoder_lens, hyps, hyps_lens,
                                        self.sos, self.eos,
                                        self.reverse_weight)

    def get_encoder_out_chunk(self, xs, state: StreamingState):
        """One streaming chunk step → (probs [B, T_out, V], new_state)."""
        encoder_out, new_state = self.encoder.forward_chunk(xs, state)
        return self.ctc.softmax(encoder_out), new_state

    def get_encoder_out_chunk_rescore(self, xs, state: StreamingState):
        """The chunk step, also returning the encoder output for a final
        rescoring pass → (encoder_out, probs, new_state)."""
        encoder_out, new_state = self.encoder.forward_chunk(xs, state)
        return encoder_out, self.ctc.softmax(encoder_out), new_state

    def init_state(self, batch_size: int, cache_size: int,
                   device=None) -> StreamingState:
        return self.encoder.init_state(batch_size, cache_size, device)
