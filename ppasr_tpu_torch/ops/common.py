"""Sequence helpers of the hybrid CTC/attention models (counterpart of
ppasr_tpu/ops/common.py:12-69): the ignore id, sos/eos framing of padded
label batches, their per-row reversal and the decoder's token accuracy, on
the labels' device."""
import torch

IGNORE_ID = -1


def add_sos_eos(ys_pad: torch.Tensor, ys_lens: torch.Tensor, sos: int,
                eos: int, ignore_id: int = IGNORE_ID):
    """ys_pad [B, U] padded with ``ignore_id``, ys_lens [B] →
    (ys_in [B, U+1]: sos + labels, padded with eos;
    ys_out [B, U+1]: labels + eos, padded with ``ignore_id``)."""
    bsz, max_u = ys_pad.shape
    pos = torch.arange(max_u + 1, device=ys_pad.device)[None, :]
    lens = ys_lens.to(torch.long)[:, None]
    ys = torch.where(ys_pad < 0, 0, ys_pad)
    zero = ys.new_zeros(bsz, 1)
    shifted = torch.cat([zero, ys], dim=1)[:, :max_u + 1]
    ys_in = torch.where(pos == 0, sos, shifted)
    ys_in = torch.where(pos > lens, eos, ys_in)
    ys_ext = torch.cat([ys, zero], dim=1)
    ys_out = torch.where(pos == lens, eos, ys_ext)
    ys_out = torch.where(pos > lens, ignore_id, ys_out)
    return ys_in, ys_out


def reverse_pad_list(ys_pad: torch.Tensor, ys_lens: torch.Tensor,
                     pad_value: float = -1.0) -> torch.Tensor:
    """Reverse each padded row in time: [1,2,3,0,0] with length 3 →
    [3,2,1,pad,pad]."""
    max_u = ys_pad.shape[1]
    pos = torch.arange(max_u, device=ys_pad.device)[None, :]
    lens = ys_lens.to(torch.long)[:, None]
    rev_idx = torch.clamp(lens - 1 - pos, 0, max_u - 1)
    gathered = torch.gather(ys_pad, 1, rev_idx)
    # a fill on the device: a CUDA graph captures it, not a host copy
    return torch.where(pos < lens, gathered,
                       torch.full((), pad_value, dtype=ys_pad.dtype,
                                  device=ys_pad.device))


def th_accuracy(pad_outputs: torch.Tensor, pad_targets: torch.Tensor,
                ignore_label: int = IGNORE_ID) -> torch.Tensor:
    """Token accuracy over the positions that are not ``ignore_label``
    (ppasr_tpu/ops/common.py:54-69). pad_outputs [B, U, V] (or [B·U, V])
    logits, pad_targets [B, U] → float32 scalar."""
    pred = pad_outputs.argmax(dim=-1).reshape(pad_targets.shape)
    mask = pad_targets != ignore_label
    correct = ((pred == pad_targets) & mask).sum()
    return (correct / torch.clamp(mask.sum(), min=1)).to(torch.float32)
