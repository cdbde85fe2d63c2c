"""Plain float32 reference of one data-parallel update of the hybrid CTC
and attention Conformer over ``world`` ranks (PPASR's recipe on one host
of several cards), built from ``reference/train.py``'s frontend, loss and
AdamW:

- the global batch of an update is [accum, world · B] utterances; rank r
  holds columns r·B … (r + 1)·B − 1 of each micro-batch, as a distributed
  sampler deals a world batch of world · B to its ranks;
- each rank's micro-step draws its dropout masks and its dither and
  augmentation from generators seeded as the program seeds them on that
  rank: the single-process seed of that stream with the rank folded in;
  the dynamic chunk is drawn without the rank, so every rank takes the
  same one (every rank's batch is padded to the same length);
- each rank's loss is its own batch's (CTC summed over its rows over B,
  the decoders' label-smoothed KL over B), and the gradient is the mean
  over the ranks and then over the micro-steps, as DDP's averaging
  all-reduce and the division by ``accum_grad`` give it. The token share
  by which the program weights each rank's attention loss applies only
  under ``length_normalized_loss``, which the published recipe leaves off:
  there the mean over the ranks is the global batch's loss;
- then the clip and AdamW of ``reference/train.py``.
"""
import math

import torch

from reference import train as ref_train


def generators(seed: int, i: int, rank: int, device) -> dict:
    """Rank ``rank``'s generators of micro-step i."""
    step = ref_train.fold(seed, i)
    return {'dropout': torch.Generator(device).manual_seed(
                ref_train.fold(ref_train.fold(step, 0), rank)),
            'chunk': torch.Generator('cpu').manual_seed(
                ref_train.fold(step, 1)),
            'frontend': torch.Generator(device).manual_seed(
                ref_train.fold(ref_train.fold(step, 2), rank))}


def updates(W0, cmvn, conf, aug, batches, seeds, world: int):
    """``reference/train.updates`` over the global batches [A, world · B,
    ...] of ``world`` ranks → (the mean loss of each update, the first
    update's clipped gradient by leaf, the weights after the last)."""
    if conf['model_conf'].get('length_normalized_loss', False):
        raise ValueError("the reference covers length_normalized_loss false")
    W = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    opt = conf['optimizer_conf']
    wd, clip = opt['weight_decay'], conf['train_conf']['grad_clip']
    losses, first = [], None
    for step, ((wav, wav_lens, text, tlens), seed) in enumerate(
            zip(batches, seeds)):
        accum, b = wav.shape[0], wav.shape[1] // world
        grads = {k: torch.zeros_like(v) for k, v in W.items()}
        total = 0.0
        for i in range(accum):
            for r in range(world):
                cols = slice(r * b, (r + 1) * b)
                g = generators(seed, i, r, wav.device)
                with torch.no_grad():
                    feats, flens = ref_train.frontend(
                        wav[i, cols], wav_lens[i, cols], g['frontend'], aug)
                with torch.enable_grad():
                    value = ref_train.loss(
                        W, cmvn, conf, feats, flens, text[i, cols],
                        tlens[i, cols], ref_train.Dropout(g['dropout']),
                        g['chunk'])
                    parts = torch.autograd.grad(value, list(W.values()),
                                                allow_unused=True)
                for k, gk in zip(W, parts):
                    if gk is not None:
                        grads[k] += gk / world
                total += float(value) / world
        losses.append(total / accum)
        with torch.no_grad():
            for k in grads:
                grads[k] /= accum
            norm = torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values()))
            if norm >= clip:
                for k in grads:
                    grads[k] *= clip / norm
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            lr, t = ref_train.warmup_lr(conf, step), step + 1
            for k, p in W.items():
                g = grads[k]
                p.mul_(1 - lr * wd)
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (v2[k].sqrt() / math.sqrt(1 - 0.999 ** t)).add_(1e-8)
                p.addcdiv_(m[k], denom, value=-lr / (1 - 0.9 ** t))
    return losses, first, {k: v.detach() for k, v in W.items()}
