"""Attention-decoder scores of CTC beam hypotheses (counterpart of
ppasr_tpu/models/rescore.py:20-72).

Each hypothesis is framed as sos + tokens → tokens + eos for the L2R
decoder and, reversed, for the R2L one; the encoder output is repeated
once per hypothesis. A hypothesis' score is the sum of its tokens' log-
probs, eos included, with the log-softmax in float32 whatever the compute
dtype; the two directions mix as (1 − w)·L2R + w·R2L, as the training
loss mixes them.
"""
import torch

from ppasr_tpu_torch.ops.common import IGNORE_ID, add_sos_eos, \
    reverse_pad_list
from ppasr_tpu_torch.ops.masks import make_non_pad_mask


def _sequence_log_prob(logits, targets):
    """logits [N, U+1, V], targets [N, U+1] padded with IGNORE_ID → [N]
    float32 sums of the targets' log-probs."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    safe = torch.where(targets == IGNORE_ID, 0, targets)
    tok = torch.gather(log_probs, -1, safe[..., None])[..., 0]
    return torch.where(targets != IGNORE_ID, tok, 0.0).sum(dim=-1)


def attention_rescore_scores(decoder, encoder_out, encoder_lens, hyps,
                             hyps_lens, sos: int, eos: int,
                             reverse_weight: float):
    """decoder: a ``BiTransformerDecoder``; encoder_out [B, T, D];
    encoder_lens [B]; hyps [B, K, U] token ids (anything past a length is
    ignored); hyps_lens [B, K] → [B, K] float32 attention log-prob scores,
    eos term included."""
    b, k, u = hyps.shape
    flat_hyps = hyps.reshape(b * k, u).to(torch.long)
    flat_lens = hyps_lens.reshape(b * k).to(torch.long)

    pos = torch.arange(u, device=hyps.device)[None, :]
    ys_pad = torch.where(pos < flat_lens[:, None], flat_hyps, IGNORE_ID)
    ys_in, ys_out = add_sos_eos(ys_pad, flat_lens, sos, eos)
    r_ys = reverse_pad_list(ys_pad, flat_lens, pad_value=IGNORE_ID)
    r_ys_in, r_ys_out = add_sos_eos(r_ys, flat_lens, sos, eos)

    memory = torch.repeat_interleave(encoder_out, k, dim=0)
    memory_mask = make_non_pad_mask(
        torch.repeat_interleave(encoder_lens, k), encoder_out.shape[1]
    )[:, None, :]

    # the R2L pass only where its score counts (JAX runs it and drops it)
    dec_out, r_dec_out = decoder(
        memory, memory_mask, ys_in, flat_lens + 1,
        r_ys_in_pad=r_ys_in if reverse_weight > 0.0 else None)
    score = _sequence_log_prob(dec_out, ys_out)
    if r_dec_out is not None and reverse_weight > 0.0:
        r_score = _sequence_log_prob(r_dec_out, r_ys_out)
        score = score * (1.0 - reverse_weight) + r_score * reverse_weight
    return score.reshape(b, k)
