"""CTC loss as a log-semiring dynamic program (counterpart of
ppasr_tpu/ops/ctc.py:18-174).

- ``ctc_loss`` (:46-83) takes [B, T, V] log-probs; ``ctc_loss_from_logits``
  (:86-102) takes (possibly bf16) logits and never keeps the dense float32
  log-softmax: ``EmissionsFromLogits`` (the custom VJP of :105-136) gathers
  the emissions of the extended labels beside a fused logsumexp, and its
  backward recomputes the softmax and scatter-adds the incoming gradient.
- The alpha recursion (:139-174) runs over time with the batch and the
  extended-label axis [B, 2U+1] vectorized; each row is frozen after its
  input length, and U = 0 reads alpha[0] alone. The gradient is autograd's
  through the loop.

Blank is 0, label padding is −1, ``LOG_EPSILON`` is −1e30 (not −inf, so no
NaN reaches the gradient). The loss is the sum over the batch divided by B
(``average_batch``), as the JAX package's. Both losses record the span
``loss.ctc`` (the forward only) while a profiler records (``utils/trace``).
This is PyTorch code, as the JAX loss is XLA code;
``F.ctc_loss(reduction='sum') / B`` is the tests' oracle.
"""
import torch

from ppasr_tpu_torch.utils.trace import span

LOG_EPSILON = -1e30


def _extended_labels(labels: torch.Tensor, label_lengths: torch.Tensor,
                     blank: int):
    """[B, U] labels → (ext [B, 2U+1] int64, valid_s, can_skip [B, 2U+1])."""
    bsz, max_u = labels.shape
    s_len = 2 * max_u + 1
    labels = torch.where(labels < 0, 0, labels).to(torch.long)
    ext = torch.full((bsz, s_len), blank, dtype=torch.long,
                     device=labels.device)
    ext[:, 1::2] = labels
    s_idx = torch.arange(s_len, device=labels.device)[None, :]
    valid_s = s_idx < (2 * label_lengths.to(torch.long) + 1)[:, None]
    ext_m2 = torch.cat([ext.new_full((bsz, 2), blank), ext[:, :-2]], dim=1)
    can_skip = (s_idx >= 2) & (ext != blank) & (ext != ext_m2)
    return ext, valid_s, can_skip


class EmissionsFromLogits(torch.autograd.Function):
    """emit[b, t, s] = log_softmax(logits)[b, t, ext[b, s]] in float32,
    without the dense [B, T, V] log-softmax; only the logits are saved."""

    @staticmethod
    def forward(ctx, logits, ext):
        x = logits.float()
        lse = torch.logsumexp(x, dim=-1)
        idx = ext[:, None, :].expand(-1, x.shape[1], -1)
        ctx.save_for_backward(logits, ext)
        return torch.gather(x, 2, idx) - lse[..., None]

    @staticmethod
    def backward(ctx, g):
        logits, ext = ctx.saved_tensors
        # d emit[b,t,s] / d logits[b,t,v] = 1[v == ext[b,s]] − softmax[b,t,v]
        p = torch.softmax(logits.float(), dim=-1)
        idx = ext[:, None, :].expand(-1, logits.shape[1], -1)
        scat = torch.zeros_like(p).scatter_add_(2, idx, g)
        g_logits = scat - p * g.sum(dim=-1)[..., None]
        return g_logits.to(logits.dtype), None


def _loss_from_emissions(emit_all, input_lengths, label_lengths, valid_s,
                         can_skip, average_batch):
    """Alpha recursion over the gathered emissions [B, T, S] (float32)."""
    bsz, max_t, s_len = emit_all.shape
    eps = torch.tensor(LOG_EPSILON, dtype=emit_all.dtype,
                       device=emit_all.device)
    emit0 = emit_all[:, 0, :]
    alpha = eps.expand(bsz, s_len).clone()
    alpha[:, 0] = emit0[:, 0]
    if s_len > 1:
        alpha[:, 1] = torch.where(label_lengths > 0, emit0[:, 1], eps)
    alpha = torch.where(valid_s, alpha, eps)
    in_lens = input_lengths.to(torch.long)
    pad1 = eps.expand(bsz, 1)
    pad2 = eps.expand(bsz, 2)
    for t in range(1, max_t):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([pad2, alpha[:, :-2]], dim=1)[:, :s_len]
        prev2 = torch.where(can_skip, prev2, eps)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new_alpha = torch.where(valid_s, merged + emit_all[:, t], eps)
        alpha = torch.where((t < in_lens)[:, None], new_alpha, alpha)
    u = label_lengths.to(torch.long)
    last = torch.gather(alpha, 1, (2 * u)[:, None])[:, 0]
    second = torch.gather(alpha, 1, torch.clamp(2 * u - 1, min=0)[:, None])[:, 0]
    second = torch.where(u > 0, second, eps)
    nll = -torch.logaddexp(last, second)
    if average_batch:
        return nll.sum() / bsz
    return nll


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0, average_batch: bool = True) -> torch.Tensor:
    """Negative log-likelihood of the CTC lattice. log_probs [B, T, V],
    input_lengths [B], labels [B, U] padded with −1, label_lengths [B] →
    sum over the batch / B (or the [B] vector when ``average_batch`` is
    False)."""
    with span('loss.ctc'):
        ext, valid_s, can_skip = _extended_labels(labels, label_lengths,
                                                  blank)
        emit_all = torch.gather(
            log_probs, 2, ext[:, None, :].expand(-1, log_probs.shape[1], -1))
        return _loss_from_emissions(emit_all, input_lengths, label_lengths,
                                    valid_s, can_skip, average_batch)


def ctc_loss_from_logits(logits: torch.Tensor, input_lengths: torch.Tensor,
                         labels: torch.Tensor, label_lengths: torch.Tensor,
                         blank: int = 0,
                         average_batch: bool = True) -> torch.Tensor:
    """``ctc_loss(log_softmax(logits.float()))`` in float32, from [B, T, V]
    logits in any float dtype; the gradient returns in the logits' dtype."""
    with span('loss.ctc'):
        ext, valid_s, can_skip = _extended_labels(labels, label_lengths,
                                                  blank)
        emit_all = EmissionsFromLogits.apply(logits, ext)
        return _loss_from_emissions(emit_all, input_lengths, label_lengths,
                                    valid_s, can_skip, average_batch)
