"""Plain float32 reference of the EfficientConformer (PPASR
``configs/efficient_conformer.yml``) over a zero-padded batch, full
context, and its CTC posteriors.

Differences from the Conformer, as the published model computes them:

- the subsampled frames are scaled by √D (the positions stay apart);
- grouped attention in ``group_layer_idx``: queries, keys, values and
  positions padded at the end to a multiple of g = ``group_size`` and
  folded to [T/g, H, g·dk], the key mask taken at every g-th frame, scores
  over √(g·dk), pos_bias_u/v of width g·dk;
- the layers in ``stride_layer_idx`` stride their convolution module
  (nothing masks its output) and take the residual through an average pool
  of ``stride`` frames (ceil mode: the last window averages the frames it
  has); the mask, the positions and the frames then keep every
  ``stride``-th step, and ``stride_kernel`` halves the conv kernel;
- layers with a stride-1 conv module zero padded frames at its input and
  output.

Since the grouped attention and the average pool read padded frames, a row's
result depends on the batch's padded length: the reference is run on the
same padded length as the program.
"""
import math

import torch
import torch.nn.functional as F

from reference import blocks


def _eff(conf):
    enc = conf['encoder_conf']
    e = enc.get('efficient_conf', {})
    strides = dict(zip(e['stride_layer_idx'], e['stride']))
    kernels, k = [], enc['cnn_module_kernel']
    for i in range(enc['num_blocks']):
        kernels.append(k)
        if i in strides and e.get('stride_kernel', True):
            k = k // strides[i]
    return strides, set(e['group_layer_idx']), e['group_size'], kernels


def param_shapes(conf: dict) -> dict:
    enc = conf['encoder_conf']
    strides, groups, g, kernels = _eff(conf)
    dk = enc['output_size'] // enc['attention_heads']

    def extra(i):
        out = {'conv': '' if i in strides else 'inner.'}
        if i in groups:
            out.update(u_width=dk * g, pos_bias=True)
        return out
    return blocks.encoder_param_shapes(
        enc['output_size'], enc['attention_heads'], enc['linear_units'],
        kernels, conf['input_dim'], conf['vocab_size'], extra,
        blocks.final_norm(conf))


def _pad_to(x, g):
    pad = -x.shape[1] % g
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))


def _fold(x, g):
    """[B, T, H, dk] → [B, H, T/g, g·dk]."""
    b, t, h, dk = x.shape
    return x.reshape(b, t // g, g, h, dk).permute(0, 3, 1, 2, 4) \
        .reshape(b, h, t // g, g * dk)


def grouped_attention(W, name, x, pos, mask, heads, g):
    """x [B, T, D]; pos [1, T, D]; mask [B, T] valid frames."""
    b, t, d = x.shape
    dk = d // heads
    split = lambda y: y.view(y.shape[0], -1, heads, dk)  # noqa: E731
    q, k, v = (_pad_to(split(blocks.lin(W, name + proj, x)), g)
               for proj in ('.linear_q', '.linear_k', '.linear_v'))
    p = _pad_to(split(blocks.lin(W, name + '.linear_pos', pos)), g)
    qg, kg, vg, pg = (_fold(y, g) for y in (q, k, v, p))
    scores = ((qg + W[name + '.pos_bias_u'][:, None]) @ kg.transpose(2, 3)
              + (qg + W[name + '.pos_bias_v'][:, None])
              @ pg.expand(b, -1, -1, -1).transpose(2, 3)) \
        / math.sqrt(dk * g)
    out = blocks.attend(scores, mask[:, ::g][:, None], vg)
    tg = out.shape[2]
    out = out.reshape(b, heads, tg, g, dk).permute(0, 2, 3, 1, 4) \
        .reshape(b, tg * g, d)[:, :t]
    return blocks.lin(W, name + '.linear_out', out)


def avg_pool_ceil(x, s):
    t = x.shape[1]
    n = -(-t // s)
    x = F.pad(x, (0, 0, 0, n * s - t))
    counts = torch.clamp(torch.arange(1, n + 1, device=x.device) * s,
                         max=t) - torch.arange(n, device=x.device) * s
    return x.reshape(x.shape[0], n, s, -1).sum(2) / counts[None, :, None]


def forward(W, cmvn, conf, feats, lens):
    """feats [B, T, 80] padded log-mel, lens [B] valid frames →
    (posteriors [B, T', V], valid output frames [B])."""
    enc = conf['encoder_conf']
    d, heads = enc['output_size'], enc['attention_heads']
    strides, groups, g, kernels = _eff(conf)
    x = blocks.subsample4(W, feats, cmvn) * math.sqrt(d)
    t = x.shape[1]
    out_lens = ((lens - 1) // 2 - 1) // 2
    mask = torch.arange(t, device=x.device)[None] < out_lens[:, None]
    pos = blocks.sinusoids(d, t, x.device)[None]
    for i, kernel in enumerate(kernels):
        p = f'encoder.layers.{i}.'
        x = x + 0.5 * blocks.ffn(W, p + 'feed_forward_macaron',
                                 blocks.layer_norm(W, p + 'norm_ff_macaron',
                                                   x))
        h = blocks.layer_norm(W, p + 'norm_mha', x)
        if i in groups:
            x = x + grouped_attention(W, p + 'self_attn', h, pos, mask,
                                      heads, g)
        else:
            x = x + blocks.rel_attention(W, p + 'self_attn', h, pos,
                                         mask[:, None], heads)[0]
        s = strides.get(i, 1)
        h = blocks.layer_norm(W, p + 'norm_conv', x)
        if s > 1:
            y, _ = blocks.conv_module(W, p + 'conv_module', h, kernel, s,
                                      mask=mask)
            x = avg_pool_ceil(x, s) + y
        else:
            x = x + blocks.conv_module(W, p + 'conv_module.inner', h,
                                       kernel, mask=mask)[0]
        x = x + 0.5 * blocks.ffn(W, p + 'feed_forward',
                                 blocks.layer_norm(W, p + 'norm_ff', x))
        if blocks.final_norm(conf):
            x = blocks.layer_norm(W, p + 'norm_final', x)
        if s > 1:
            mask, pos = mask[:, ::s], pos[:, ::s]
            x = x[:, :mask.shape[1]]
    x = blocks.layer_norm(W, 'encoder.after_norm', x)
    return blocks.ctc_probs(W, x), mask.sum(1)
