"""Conformer model: encoder, CTC head and attention decoder (counterpart of
ppasr_tpu/models/conformer.py:29-204).

``forward`` is the training loss (:65-106): ctc_weight·CTC + (1 −
ctc_weight)·attention, the attention loss the label-smoothed KL of the
left-to-right decoder mixed with the right-to-left decoder's over
``reverse_pad_list`` labels by ``reverse_weight``, and the decoder's token
accuracy; it returns ``loss``, ``loss_att``, ``loss_ctc`` and
``th_accuracy`` (the last two None when ``ctc_weight`` is 1). Dropout and
the dynamic chunk follow ``train()`` / ``eval()`` (the JAX
``deterministic``); ``rngs`` gives the step's ``'dropout'`` and ``'chunk'``
generators, and under tensor parallelism ``'dropout_sharded'``.

``streaming=True`` makes the encoder dynamic-chunk and causal (:52-55).
Entry points: ``get_encoder_out`` (full context, :114-120),
``get_encoder_logits`` (full context, CTC logits with no softmax, :128-136),
``encode_for_rescore`` (the encoder output beside the CTC posteriors,
:138-145), ``attention_rescore_scores`` (the decoder's scores of beam
hypotheses, :147-155), ``get_encoder_out_chunk`` (one streaming step,
:157-162), ``stream_step`` (that step, as the streaming loops call it,
also returning the encoder output for rescoring: :164-170) and
``init_state`` (:172-190).

The attention decoder exists where the JAX model has its parameters: when
``ctc_weight < 1`` (the training loss calls it only then); its R2L half when
``r_num_blocks > 0``. ``set_compute_dtype`` is the flax ``dtype``
(``models/base.cast_for_compute``): CTC posteriors and the decoder's scores
stay float32; ``set_compute_dtype(dtype, at_use=True)`` computes in the
dtype over float32 parameters (``models/base.cast_at_use``), for training.
"""
from typing import Optional

import torch

from ppasr_tpu_torch.models.base import ASRModel, dropout_generator
from ppasr_tpu_torch.models.conformer_encoder import (ConformerEncoder,
                                                      StreamingState)
from ppasr_tpu_torch.models.ctc import CTCHead
from ppasr_tpu_torch.models.rescore import attention_rescore_scores
from ppasr_tpu_torch.models.transformer_decoder import BiTransformerDecoder
from ppasr_tpu_torch.ops.common import (IGNORE_ID, add_sos_eos,
                                        reverse_pad_list, th_accuracy)
from ppasr_tpu_torch.ops.label_smoothing import label_smoothing_loss


class ConformerModel(ASRModel):
    """The hybrid CTC + attention model. ``encoder_class`` and
    ``encoder_conf_for`` (the encoder's options for ``streaming``) are the
    hooks the Squeezeformer and the EfficientConformer set; the rest, the
    loss and the entry points included, is the same for the three."""
    encoder_class = ConformerEncoder

    @staticmethod
    def encoder_conf_for(conf: dict, streaming: bool) -> dict:
        conf = dict(conf)
        if streaming:
            conf.update(use_dynamic_chunk=True, causal=True)
        return conf

    def __init__(self, input_size: int, vocab_size: int,
                 streaming: bool = True, encoder_conf: Optional[dict] = None,
                 decoder_conf: Optional[dict] = None, ctc_weight: float = 0.3,
                 lsm_weight: float = 0.1, reverse_weight: float = 0.3,
                 length_normalized_loss: bool = False,
                 cmvn_mean: Optional[tuple] = None,
                 cmvn_istd: Optional[tuple] = None):
        super().__init__()
        conf = self.encoder_conf_for(dict(encoder_conf or {}), streaming)
        self.streaming = streaming
        self.vocab_size = vocab_size
        self.ctc_weight = ctc_weight
        self.lsm_weight = lsm_weight
        self.length_normalized_loss = length_normalized_loss
        self.reverse_weight = reverse_weight
        self.sos = self.eos = vocab_size - 1
        self.encoder = self.encoder_class(input_size, cmvn_mean=cmvn_mean,
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

    def forward(self, speech, speech_lens, text, text_lens, rngs=None):
        """Training loss (ppasr_tpu/models/conformer.py:65-106). speech
        [B, T, D] features, speech_lens [B], text [B, U] padded with −1,
        text_lens [B]; ``rngs`` {'dropout', 'chunk'} generators. Returns
        {loss, loss_att, loss_ctc, th_accuracy}."""
        rngs = rngs or {}
        with dropout_generator(self, rngs.get('dropout'),
                               rngs.get('dropout_sharded')):
            return self._loss(speech, speech_lens, text, text_lens,
                              rngs.get('chunk'))

    def _loss(self, speech, speech_lens, text, text_lens, chunk_rng):
        encoder_out, encoder_mask = self.encoder(
            speech, speech_lens, chunk_generator=chunk_rng)
        encoder_lens = self._lens(encoder_mask)
        loss_ctc = self.ctc(encoder_out, encoder_lens, text, text_lens)
        loss_att = acc_att = None
        if self.decoder is not None:
            ys_in, ys_out = add_sos_eos(text, text_lens, self.sos, self.eos)
            r_text = reverse_pad_list(text, text_lens, pad_value=IGNORE_ID)
            r_ys_in, r_ys_out = add_sos_eos(r_text, text_lens, self.sos,
                                            self.eos)
            dec_out, r_dec_out = self.decoder(
                encoder_out, encoder_mask, ys_in, text_lens + 1,
                r_ys_in_pad=r_ys_in)
            loss_att = label_smoothing_loss(
                dec_out.float(), ys_out, self.lsm_weight,
                self.length_normalized_loss)
            if r_dec_out is not None and self.reverse_weight > 0.0:
                loss_r2l = label_smoothing_loss(
                    r_dec_out.float(), r_ys_out, self.lsm_weight,
                    self.length_normalized_loss)
                loss_att = (loss_att * (1 - self.reverse_weight)
                            + loss_r2l * self.reverse_weight)
            acc_att = th_accuracy(dec_out.float(), ys_out)
        if loss_att is None:
            loss = loss_ctc
        else:
            loss = self.ctc_weight * loss_ctc \
                + (1 - self.ctc_weight) * loss_att
        return {'loss': loss, 'loss_att': loss_att, 'loss_ctc': loss_ctc,
                'th_accuracy': acc_att}

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

    def stream_step(self, xs, frames: int, state, keep_encoder=False):
        """The step every streaming loop calls: windows [B, window, D] of
        ``frames`` valid frames (unread here) → (probs [B, T_out, V], the
        encoder output if ``keep_encoder`` else None, new_state). Looks up
        ``get_encoder_out_chunk`` on the instance, where it may be wrapped."""
        if keep_encoder:
            encoder_out, new_state = self.encoder.forward_chunk(xs, state)
            return self.ctc.softmax(encoder_out), encoder_out, new_state
        probs, new_state = self.get_encoder_out_chunk(xs, state)
        return probs, None, new_state

    def init_state(self, batch_size: int, cache_size: int,
                   device=None) -> StreamingState:
        return self.encoder.init_state(batch_size, cache_size, device)
