"""Label-smoothing KL loss of the attention decoder (counterpart of
ppasr_tpu/ops/label_smoothing.py:14-42): KL between the smoothed one-hot
target and the log-softmax of the logits, with ``IGNORE_ID`` positions
masked. The constant ``true · log true`` term is kept, so the value equals
the JAX package's (and paddle's KLDivLoss), not only its gradient. The sum
is divided by B, or by the count of target tokens when
``normalize_length``."""
import torch

from ppasr_tpu_torch.ops.common import IGNORE_ID


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1,
                         normalize_length: bool = False,
                         ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """logits [B, U, V], targets [B, U] (padding ``ignore_id``) → scalar."""
    bsz, _, vocab = logits.shape
    confidence = 1.0 - smoothing
    low = smoothing / (vocab - 1)
    mask = targets != ignore_id
    tgt = torch.where(mask, targets, 0).to(torch.long)
    log_probs = torch.log_softmax(logits, dim=-1)
    true_dist = torch.full_like(log_probs, low).scatter_(2, tgt[..., None],
                                                         confidence)
    log_true = torch.where(true_dist > 0, torch.log(true_dist), 0.0)
    kl = (true_dist * (log_true - log_probs)).sum(dim=-1)
    kl = torch.where(mask, kl, 0.0)
    denom = torch.clamp(mask.sum(), min=1) if normalize_length else bsz
    return kl.sum() / denom
