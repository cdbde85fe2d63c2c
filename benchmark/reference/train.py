"""Plain float32 reference of one training update of the hybrid CTC and
attention Conformer (PPASR ``configs/conformer.yml``'s recipe):

- the frontend: the kaldi fbank of each padded row with the dither (one
  N(0, 1) draw per framed sample, added before the DC removal), then
  SpecAugment (a time warp, 2 frequency and 2 time masks filled with the
  utterance's mean) and SpecSub (3 spans replaced by earlier frames of the
  unmasked features), gated per utterance;
- the encoder in training: dropout on the positional stage, inside and
  after each feed-forward, on the attention weights and after each branch;
  a dynamic chunk mask drawn per micro-batch (the full context when the
  draw exceeds half the frames, else a chunk of draw % 25 + 1 frames);
- the CTC loss (summed over the batch, over B), the left-to-right and
  right-to-left transformer decoders (embedding ×√d plus sinusoids,
  causal self-attention, attention to the encoder, a ReLU feed-forward,
  LayerNorm eps 1e-12) and their label-smoothed KL losses, mixed
  0.7/0.3 and with CTC 0.3/0.7;
- the update: the micro-steps' gradients summed and divided by their count,
  clipped to a global norm of ``grad_clip`` (scaled only above it), then
  AdamW (β 0.9/0.999, ε 1e-8, decoupled decay) at WarmupLR's rate for the
  update's index.

The random draws (dropout masks, chunk sizes, dither, augmentation) come
from generators seeded as the program seeds its own for the same update
and micro-step, and are drawn in the same order and shapes, so both sides
see the same masks: a micro-step's seed is ``fold(fold(seed, i), k)`` for
the dropout (k 0, on the card), chunk (k 1, on the CPU) and frontend (k 2,
on the card) streams, ``fold`` a hash of its integers by numpy's
``SeedSequence``.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

from reference import blocks, fbank

IGNORE = -1
RAW = 1 << 30


def fold(seed: int, *data: int) -> int:
    words = np.random.SeedSequence([seed, *data]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def generators(seed: int, i: int, device):
    step = fold(seed, i)
    out = {}
    for name, k, dev in (('dropout', 0, device), ('chunk', 1, 'cpu'),
                         ('frontend', 2, device)):
        out[name] = torch.Generator(dev).manual_seed(fold(step, k))
    return out


class Dropout:
    """Inverted dropout at keep probability q/256, q = round((1 − rate)·256)
    in [1, 255], its mask ``bits < q`` from uint8 draws."""

    def __init__(self, generator):
        self.g = generator

    def __call__(self, x, rate):
        if rate == 0.0:
            return x
        q = min(255, max(1, round((1.0 - rate) * 256)))
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             device=x.device, generator=self.g)
        return torch.where(bits < q, x / (q / 256.0), 0.0)


# ------------------------------------------------------------ frontend

def frontend(wav, wav_lens, g, aug):
    """[B, S] int16-scaled waveforms → (features [B, T, 80], frames [B])
    with the dither and the feature augmentation of ``aug``."""
    bsz, s = wav.shape
    t = 1 + (s - fbank.WINDOW) // fbank.SHIFT
    noise = torch.randn((bsz, t, fbank.WINDOW), generator=g,
                        device=wav.device)
    idx = torch.arange(t)[:, None] * fbank.SHIFT \
        + torch.arange(fbank.WINDOW)[None, :]
    frames = wav.double().cpu()[:, idx] + noise.double().cpu()
    feats = torch.from_numpy(np.stack([
        fbank.frames_logmel(f.numpy()) for f in frames])).to(wav.device)
    lens = torch.clamp(torch.where(wav_lens >= fbank.WINDOW,
                                   1 + (wav_lens - fbank.WINDOW)
                                   // fbank.SHIFT, 0), max=t)
    return augment(feats, lens, g, aug), lens


def augment(x, lens, g, aug):
    bsz, t, d = x.shape
    dev = x.device
    w, nf, nt = aug['max_time_warp'], aug['n_freq_masks'], aug['n_time_masks']
    ns = aug['spec_sub_num']
    raw = lambda n: torch.randint(0, RAW, (n,), generator=g,  # noqa: E731
                                  device=dev)
    centre_raw = raw(bsz)
    shift = torch.randint(-w, w + 1, (bsz,), generator=g, device=dev)
    freq = raw(bsz * nf * 2).view(bsz, nf, 2)
    time = raw(bsz * nt * 2).view(bsz, nt, 2)
    sub = raw(bsz * ns * 3).view(bsz, ns, 3)
    take = torch.rand(bsz, generator=g, device=dev) < aug['prob']
    out = []
    for b in range(bsz):
        n = max(int(lens[b]), 1)
        y = warp(x[b], n, w, int(centre_raw[b]), int(shift[b]))
        valid = y[:n]
        fill = valid.mean() if not aug['replace_with_zero'] else 0.0
        y = y.clone()
        max_f = int(d * aug['max_f_ratio'])
        for k in range(nf):
            width = int(freq[b, k, 0]) % (max_f + 1)
            start = int(freq[b, k, 1]) % max(d - width, 1)
            y[:n, start:start + width] = fill
        max_w = max(int(np.float32(n) * np.float32(aug['max_t_ratio'])), 0)
        for k in range(nt):
            width = int(time[b, k, 0]) % (max_w + 1)
            start = int(time[b, k, 1]) % max(n - width, 1)
            y[start:min(start + width, n)] = fill
        orig = y.clone()
        for k in range(ns):
            start = int(sub[b, k, 0]) % n
            length = 1 + int(sub[b, k, 1]) % aug['spec_sub_max_t']
            pos = int(sub[b, k, 2]) % max(start + 1, 1)
            end = min(n, start + length)
            y[start:end] = orig[start - pos:end - pos]
        out.append(y if bool(take[b]) else x[b])
    return torch.stack(out)


def warp(x, n, w, centre_raw, shift):
    """Time warp of the first n frames: [0, c) stretched over [0, c') and
    [c, n − 1] over [c', n), linear interpolation between frames; the
    identity where n − w ≤ w and on padding."""
    if n - w <= w or w <= 0:
        return x
    c = w + centre_raw % max(n - 2 * w, 1)
    cw = min(max(c + shift, 1), n - 1)
    i = torch.arange(x.shape[0], device=x.device, dtype=torch.float32)
    left = i * np.float32(np.float32(c) / np.float32(cw))
    right = c + (i - cw) * np.float32(np.float32(n - 1 - c)
                                      / np.float32(max(n - cw, 1)))
    src = torch.where(i < cw, left, right).clamp(0.0, float(n - 1))
    src = torch.where(i < n, src, i)
    lo = src.floor().long()
    hi = torch.clamp(lo + 1, max=x.shape[0] - 1)
    frac = (src - lo.float())[:, None]
    return x[lo] * (1 - frac) + x[hi] * frac


# ------------------------------------------------------------ the model

def param_shapes(conf: dict) -> dict:
    """The encoder's and CTC head's leaves (``reference.conformer``) and
    the two decoders'."""
    from reference import conformer
    shapes = dict(conformer.param_shapes(conf))
    dec = conf['decoder_conf']
    d, v, f = conf['encoder_conf']['output_size'], conf['vocab_size'], \
        dec['linear_units']
    for side, n in (('left', dec['num_blocks']),
                    ('right', dec['r_num_blocks'])):
        p = f'decoder.{side}_decoder.'
        shapes[p + 'embed.weight'] = (v, d)
        for i in range(n):
            q = f'{p}layer_{i}.'
            for norm in ('norm1', 'norm2', 'norm3'):
                shapes[q + norm + '.weight'] = (d,)
                shapes[q + norm + '.bias'] = (d,)
            for att in ('self_attn', 'src_attn'):
                for proj in ('linear_q', 'linear_k', 'linear_v', 'linear_out'):
                    shapes[f'{q}{att}.{proj}.weight'] = (d, d)
                    shapes[f'{q}{att}.{proj}.bias'] = (d,)
            shapes[q + 'feed_forward.w_1.weight'] = (f, d)
            shapes[q + 'feed_forward.w_1.bias'] = (f,)
            shapes[q + 'feed_forward.w_2.weight'] = (d, f)
            shapes[q + 'feed_forward.w_2.bias'] = (d,)
        shapes[p + 'after_norm.weight'] = (d,)
        shapes[p + 'after_norm.bias'] = (d,)
        shapes[p + 'output_layer.weight'] = (v, d)
        shapes[p + 'output_layer.bias'] = (v,)
    return shapes


def encode(W, cmvn, conf, feats, lens, drop, chunk_g):
    """The encoder in training → (out [B, T', D], valid [B, T'])."""
    enc = conf['encoder_conf']
    heads, rate = enc['attention_heads'], enc['dropout_rate']
    x = blocks.subsample4(W, feats, cmvn)
    t = x.shape[1]
    out_lens = ((lens - 1) // 2 - 1) // 2
    valid = torch.arange(t, device=x.device)[None] < out_lens[:, None]
    pos = blocks.sinusoids(enc['output_size'], t, x.device)[None]
    x = drop(x, enc['positional_dropout_rate'])
    draw = int(torch.randint(1, max(t, 2), (), generator=chunk_g))
    torch.randint(0, RAW, (), generator=chunk_g)
    chunk = t if draw > t // 2 else draw % 25 + 1
    i = torch.arange(t, device=x.device)
    mask = valid[:, None, :] & (i[None, :] < (i[:, None] // chunk + 1)
                                * chunk)[None]
    ffn_drop = (drop, rate)
    for n in range(enc['num_blocks']):
        p = f'encoder.layers.{n}.'
        x = x + 0.5 * drop(blocks.ffn(W, p + 'feed_forward_macaron',
                                      blocks.layer_norm(
                                          W, p + 'norm_ff_macaron', x),
                                      drop=ffn_drop), rate)
        y, _ = blocks.rel_attention(
            W, p + 'self_attn', blocks.layer_norm(W, p + 'norm_mha', x), pos,
            mask, heads, drop=(drop, enc['attention_dropout_rate']))
        x = x + drop(y, rate)
        y, _ = blocks.conv_module(W, p + 'conv_module',
                                  blocks.layer_norm(W, p + 'norm_conv', x),
                                  enc['cnn_module_kernel'], mask=valid)
        x = x + drop(y, rate)
        x = x + 0.5 * drop(blocks.ffn(W, p + 'feed_forward',
                                      blocks.layer_norm(W, p + 'norm_ff', x),
                                      drop=ffn_drop), rate)
        if blocks.final_norm(conf):
            x = blocks.layer_norm(W, p + 'norm_final', x)
    return blocks.layer_norm(W, 'encoder.after_norm', x), valid


def decode(W, side, conf, memory, valid, ys_in, ys_lens, drop):
    dec = conf['decoder_conf']
    p = f'decoder.{side}_decoder.'
    d = conf['encoder_conf']['output_size']
    u = ys_in.shape[1]
    x = F.embedding(ys_in, W[p + 'embed.weight']) * math.sqrt(d) \
        + blocks.sinusoids(d, u, memory.device)[None]
    x = drop(x, dec['positional_dropout_rate'])
    j = torch.arange(u, device=x.device)
    tgt = (j[None, :] < ys_lens[:, None])[:, None, :] \
        & (j[:, None] >= j[None, :])[None]
    rate = dec['dropout_rate']
    n = dec['num_blocks'] if side == 'left' else dec['r_num_blocks']
    for i in range(n):
        q = f'{p}layer_{i}.'
        h = blocks.layer_norm(W, q + 'norm1', x, 1e-12)
        x = x + drop(blocks.attention(
            W, q + 'self_attn', h, h, tgt, dec['attention_heads'],
            (drop, dec['self_attention_dropout_rate'])), rate)
        h = blocks.layer_norm(W, q + 'norm2', x, 1e-12)
        x = x + drop(blocks.attention(
            W, q + 'src_attn', h, memory, valid[:, None, :],
            dec['attention_heads'],
            (drop, dec['src_attention_dropout_rate'])), rate)
        h = blocks.layer_norm(W, q + 'norm3', x, 1e-12)
        x = x + drop(blocks.ffn(W, q + 'feed_forward', h, F.relu,
                                (drop, rate)), rate)
    x = blocks.layer_norm(W, p + 'after_norm', x, 1e-12)
    return blocks.lin(W, p + 'output_layer', x)


def sos_eos(text, lens, token):
    """(decoder input: sos + labels padded with eos, target: labels + eos
    padded with IGNORE)."""
    b, u = text.shape
    pos = torch.arange(u + 1, device=text.device)[None]
    ys = torch.cat([text.clamp(min=0), text.new_zeros(b, 1)], 1)
    ys_in = torch.cat([text.new_full((b, 1), token), ys[:, :u]], 1)
    ys_in = torch.where(pos > lens[:, None], token, ys_in)
    ys_out = torch.where(pos == lens[:, None], token, ys)
    return ys_in, torch.where(pos > lens[:, None], IGNORE, ys_out)


def reverse(text, lens):
    u = text.shape[1]
    pos = torch.arange(u, device=text.device)[None]
    idx = (lens[:, None] - 1 - pos).clamp(0, u - 1)
    return torch.where(pos < lens[:, None], text.gather(1, idx), IGNORE)


def smoothed_kl(logits, target, smoothing):
    v = logits.shape[-1]
    keep = target != IGNORE
    true = torch.full_like(logits, smoothing / (v - 1)).scatter_(
        2, target.clamp(min=0)[..., None], 1.0 - smoothing)
    kl = (true * (torch.log(true) - torch.log_softmax(logits, -1))).sum(-1)
    return torch.where(keep, kl, 0.0).sum() / logits.shape[0]


def loss(W, cmvn, conf, feats, flens, text, tlens, drop, chunk_g):
    """The hybrid loss of one micro-batch."""
    mc = conf['model_conf']
    memory, valid = encode(W, cmvn, conf, feats, flens, drop, chunk_g)
    logp = torch.log_softmax(blocks.lin(W, 'ctc.ctc_lo', memory), -1)
    ctc = F.ctc_loss(logp.transpose(0, 1), text.clamp(min=0),
                     valid.sum(1), tlens, blank=0,
                     reduction='sum') / feats.shape[0]
    eos = conf['vocab_size'] - 1
    ys_in, ys_out = sos_eos(text, tlens, eos)
    r_in, r_out = sos_eos(reverse(text, tlens), tlens, eos)
    l2r = smoothed_kl(decode(W, 'left', conf, memory, valid, ys_in, tlens + 1,
                             drop), ys_out, mc['lsm_weight'])
    r2l = smoothed_kl(decode(W, 'right', conf, memory, valid, r_in, tlens + 1,
                             drop), r_out, mc['lsm_weight'])
    att = l2r * (1 - mc['reverse_weight']) + r2l * mc['reverse_weight']
    return mc['ctc_weight'] * ctc + (1 - mc['ctc_weight']) * att


def warmup_lr(conf: dict, step: int) -> float:
    opt = conf['optimizer_conf']
    f32 = np.float32
    lr, warm = opt['learning_rate'], opt['scheduler_conf']['warmup_steps']
    s = f32(step + 1)
    value = f32(lr) * f32(warm ** 0.5) * min(s ** f32(-0.5),
                                             s * f32(warm ** -1.5))
    return float(value)


def updates(W0, cmvn, conf, aug, batches, seeds):
    """Run one update per (batch, seed) from weights ``W0`` → (the mean
    loss of each update, the first update's clipped gradient by leaf, the
    weights after the last update). A batch is (wav [A, B, S], wav_lens
    [A, B], text [A, B, U], text_lens [A, B])."""
    W = {k: v.detach().clone().requires_grad_(True) for k, v in W0.items()}
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    opt = conf['optimizer_conf']
    wd, clip = opt['weight_decay'], conf['train_conf']['grad_clip']
    losses, first = [], None
    for step, ((wav, wav_lens, text, tlens), seed) in enumerate(
            zip(batches, seeds)):
        accum = wav.shape[0]
        grads = {k: torch.zeros_like(v) for k, v in W.items()}
        total = 0.0
        for i in range(accum):
            g = generators(seed, i, wav.device)
            with torch.no_grad():
                feats, flens = frontend(wav[i], wav_lens[i], g['frontend'],
                                        aug)
            with torch.enable_grad():
                value = loss(W, cmvn, conf, feats, flens, text[i], tlens[i],
                             Dropout(g['dropout']), g['chunk'])
                parts = torch.autograd.grad(value, list(W.values()),
                                            allow_unused=True)
            for (k, _), gk in zip(W.items(), parts):
                if gk is not None:
                    grads[k] += gk
            total += float(value)
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
            lr, t = warmup_lr(conf, step), step + 1
            for k, p in W.items():
                g = grads[k]
                p.mul_(1 - lr * wd)
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (v2[k].sqrt() / math.sqrt(1 - 0.999 ** t)).add_(1e-8)
                p.addcdiv_(m[k], denom, value=-lr / (1 - 0.9 ** t))
    return losses, first, {k: v.detach() for k, v in W.items()}
