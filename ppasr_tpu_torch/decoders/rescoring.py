"""Attention rescoring: the CTC prefix beam search, then the model's
attention decoder over every beam (counterpart of
ppasr_tpu/decoders/rescoring.py:26-86).

1. ``TorchBeamSearchDecoder.decode_batch_states`` leaves all K beams of
   each utterance, with their CTC scores, in a ``BeamState`` on the model's
   device;
2. ``ConformerModel.attention_rescore_scores`` scores every hypothesis in
   one batched decoder pass (L2R and, with ``reverse_weight > 0``, R2L);
3. total = attention score + ``ctc_weight`` · CTC score, dead beams kept
   out; the best beam of each utterance is packed into one int32 tensor,
   which is the one read back to the host.
"""
import torch

from ppasr_tpu_torch.decoders.beam_search_torch import (
    NEG_INF, TorchBeamSearchDecoder, all_hypotheses, pack_hypothesis_at,
    unpack_results)


class AttentionRescoringDecoder:
    def __init__(self, model, vocab_list, ctc_weight: float = 0.3,
                 max_hyp_len: int = 200, device='cuda:0', **beam_conf):
        """``model``: a ``ConformerModel`` with its attention decoder, on
        ``device``; ``beam_conf``: the beam search's options."""
        if getattr(model, 'decoder', None) is None:
            raise ValueError(f"{type(model).__name__} has no attention "
                             f"decoder to rescore with")
        self.model = model
        self.vocab_list = list(vocab_list)
        self.ctc_weight = float(ctc_weight)
        self.max_hyp_len = int(max_hyp_len)
        self.beam = TorchBeamSearchDecoder(vocab_list, device=device,
                                           **beam_conf)
        self.device = self.beam.device

    def decode_batch_rescore(self, encoder_out, probs_batch, lens):
        """[B, T, D] encoder output, [B, T, V] CTC posteriors and [B]
        lengths, on the device → list of (score, text)."""
        states = self.beam.decode_batch_states(probs_batch, lens)
        lens = torch.as_tensor(lens, device=self.device)
        hyps, hyp_lens, ctc_scores = all_hypotheses(states, self.max_hyp_len)
        att = self.model.attention_rescore_scores(encoder_out, lens, hyps,
                                                  hyp_lens)
        total = att + self.ctc_weight * ctc_scores
        total = torch.where(ctc_scores > NEG_INF / 2, total, NEG_INF)
        best = torch.argmax(total, dim=1)
        return unpack_results(pack_hypothesis_at(states, best, total),
                              self.vocab_list)

    def rescore_utterance(self, enc_chunks, probs_chunks):
        """The final pass over one streamed utterance: its per-chunk
        [T_i, D] encoder outputs and [T_i, V] posteriors (tensors on the
        device) → (score, text). Time is padded to a 64-frame bucket, as
        the JAX decoder pads it to reuse its compiled programs."""
        enc = torch.cat(list(enc_chunks))
        probs = torch.cat(list(probs_chunks)).float()
        t = probs.shape[0]
        bucket = max(16, -(-t // 64) * 64)
        enc_p = enc.new_zeros(1, bucket, enc.shape[1])
        enc_p[0, :t] = enc
        probs_p = probs.new_zeros(1, bucket, probs.shape[1])
        probs_p[0, :t] = probs
        return self.decode_batch_rescore(
            enc_p, probs_p, torch.tensor([t], device=self.device))[0]
