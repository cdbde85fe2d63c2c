"""Plain float32 building blocks of the Conformer family, written as
functions of a flat weight dict ``W`` keyed by parameter name.

Each follows the published PPASR/WeNet layer equations as the models
compute them at inference (no dropout):

- global CMVN ``(x − mean) · istd``;
- conv2d ×4 subsampling: two 3×3 stride-2 VALID convolutions with ReLU,
  the [C, F] planes flattened feature-major ((f, c) order), a linear layer;
- the macaron block: ½·FFN, self-attention, convolution module, ½·FFN,
  each a pre-LayerNorm residual branch, then the block-final LayerNorm
  (``norm_final``) where the configuration has ``block_final_norm``;
- relative-position attention without a rel-shift:
  ((q + u)·kᵀ + (q + v)·pᵀ) / √dk, p the projected sinusoid rows of the key
  positions, masked keys at −∞ and their weights then zeroed;
- the causal convolution module: pointwise to 2C, GLU, depthwise (left
  context only), LayerNorm, swish, pointwise.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def lin(W, name, x):
    return F.linear(x, W[name + '.weight'], W.get(name + '.bias'))


def layer_norm(W, name, x, eps=LN_EPS):
    return F.layer_norm(x, (x.shape[-1],), W[name + '.weight'],
                        W[name + '.bias'], eps)


def swish(x):
    return x * torch.sigmoid(x)


def sinusoids(d: int, n: int, device) -> torch.Tensor:
    """[n, d] interleaved sin/cos positions, computed in float32."""
    pos = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d))
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def subsample4(W, x, cmvn):
    """[B, T, 80] features → [B, ((T − 1) // 2 − 1) // 2, D]."""
    mean, istd = cmvn
    x = ((x - mean) * istd)[:, None]
    x = F.relu(F.conv2d(x, W['encoder.embed.Conv_0.weight'],
                        W['encoder.embed.Conv_0.bias'], stride=2))
    x = F.relu(F.conv2d(x, W['encoder.embed.Conv_1.weight'],
                        W['encoder.embed.Conv_1.bias'], stride=2))
    b, c, t, f = x.shape
    return lin(W, 'encoder.embed.Dense_0',
               x.permute(0, 2, 3, 1).reshape(b, t, f * c))


def ffn(W, name, x, act=None, drop=None):
    """w_2(act(w_1 x)), swish unless ``act``; ``drop`` (a (fn, rate)
    pair) drops the hidden units in training."""
    h = (act or swish)(lin(W, name + '.w_1', x))
    if drop is not None:
        h = drop[0](h, drop[1])
    return lin(W, name + '.w_2', h)


def attend(scores, mask, v, drop=None):
    """softmax over keys with ``mask`` [B, 1|T, S] (True = attend) →
    weights · v, with v [B, H, S, dk]; ``drop`` drops weights."""
    m = mask[:, None]
    scores = scores.masked_fill(~m, -math.inf)
    w = torch.softmax(scores, dim=-1).nan_to_num(0.0).masked_fill(~m, 0.0)
    if drop is not None:
        w = drop[0](w, drop[1])
    return w @ v


def attention(W, name, q_in, kv_in, mask, heads, drop=None):
    """Plain multi-head attention (no positions): q_in [B, T, D], kv_in
    [B, S, D], mask [B, 1|T, S]."""
    b, t, d = q_in.shape
    dk = d // heads
    split = lambda y: y.view(b, -1, heads, dk).transpose(1, 2)  # noqa: E731
    q = split(lin(W, name + '.linear_q', q_in))
    k = split(lin(W, name + '.linear_k', kv_in))
    v = split(lin(W, name + '.linear_v', kv_in))
    out = attend(q @ k.transpose(2, 3) / math.sqrt(dk), mask, v, drop)
    return lin(W, name + '.linear_out', out.transpose(1, 2).reshape(b, t, d))


def rel_attention(W, name, x, pos, mask, heads, cache=None, drop=None):
    """x [B, T, D] queries and new keys; pos [1|B, S, D] sinusoid rows of
    the S key positions; cache (k, v) [B, C, H, dk] prepended to the keys.
    → (out [B, T, D], (k, v) of all S keys)."""
    b, t, d = x.shape
    dk = d // heads
    split = lambda y: y.view(b, -1, heads, dk)  # noqa: E731
    q = split(lin(W, name + '.linear_q', x))
    k = split(lin(W, name + '.linear_k', x))
    v = split(lin(W, name + '.linear_v', x))
    if cache is not None:
        k, v = torch.cat([cache[0], k], 1), torch.cat([cache[1], v], 1)
    p = lin(W, name + '.linear_pos', pos).view(pos.shape[0], -1, heads, dk)
    qu = (q + W[name + '.pos_bias_u']).transpose(1, 2)
    qv = (q + W[name + '.pos_bias_v']).transpose(1, 2)
    scores = (qu @ k.permute(0, 2, 3, 1)
              + qv @ p.expand(b, -1, -1, -1).permute(0, 2, 3, 1)) \
        / math.sqrt(dk)
    out = attend(scores, mask, v.transpose(1, 2), drop)
    return lin(W, name + '.linear_out',
               out.transpose(1, 2).reshape(b, t, d)), (k, v)


def conv_module(W, name, x, kernel, stride=1, mask=None, cache=None):
    """Causal convolution module over x [B, T, D]; ``mask`` [B, T] zeroes
    padded frames at the input (and at the output when ``stride`` is 1);
    ``cache`` [B, kernel − 1, D] is the left context (zeros when None).
    → (y [B, ⌈T / stride⌉, D], the last kernel − 1 input frames)."""
    if mask is not None:
        x = x * mask[..., None]
    left = cache if cache is not None else x.new_zeros(
        x.shape[0], kernel - 1, x.shape[2])
    x = torch.cat([left, x], 1)
    new_cache = x[:, x.shape[1] - (kernel - 1):]
    a, g = lin(W, name + '.pointwise_conv1', x).chunk(2, dim=-1)
    y = F.conv1d((a * torch.sigmoid(g)).transpose(1, 2),
                 W[name + '.depthwise_conv.weight'],
                 W[name + '.depthwise_conv.bias'], stride=stride,
                 groups=x.shape[2]).transpose(1, 2)
    y = lin(W, name + '.pointwise_conv2',
            swish(layer_norm(W, name + '.norm', y)))
    if mask is not None and stride == 1:
        y = y * mask[..., None]
    return y, new_cache


def ctc_probs(W, x):
    return torch.softmax(lin(W, 'ctc.ctc_lo', x), dim=-1)


def final_norm(conf: dict) -> bool:
    """Whether each block ends in its own LayerNorm (the published
    layer's ``norm_final``; the models' default)."""
    return bool(conf['encoder_conf'].get('block_final_norm', True))


def encoder_param_shapes(d, heads, ffn_units, kernels, n_mels, vocab,
                         layer_extra=None, block_norm=True):
    """{name: shape} of the encoder and CTC head of a macaron Conformer
    with ``len(kernels)`` layers: conv2d ×4 input, layer i's conv module of
    kernel ``kernels[i]``. ``layer_extra(i)`` returns a layer's differences:
    {'conv': prefix of its conv module under ``conv_module``, 'u_width':
    the width of pos_bias_u/v, 'pos_bias': whether linear_pos has a
    bias}; ``block_norm`` adds each layer's ``norm_final``."""
    f1 = (n_mels - 3) // 2 + 1
    f2 = (f1 - 3) // 2 + 1
    s = {'encoder.embed.Conv_0.weight': (d, 1, 3, 3),
         'encoder.embed.Conv_0.bias': (d,),
         'encoder.embed.Conv_1.weight': (d, d, 3, 3),
         'encoder.embed.Conv_1.bias': (d,),
         'encoder.embed.Dense_0.weight': (d, f2 * d),
         'encoder.embed.Dense_0.bias': (d,)}

    def linear(name, n_out, n_in, bias=True):
        s[name + '.weight'] = (n_out, n_in)
        if bias:
            s[name + '.bias'] = (n_out,)

    def norm(name):
        s[name + '.weight'] = (d,)
        s[name + '.bias'] = (d,)

    for i, kernel in enumerate(kernels):
        extra = layer_extra(i) if layer_extra else {}
        p = f'encoder.layers.{i}.'
        for ff in ('feed_forward_macaron', 'feed_forward'):
            norm(p + ('norm_ff_macaron' if ff == 'feed_forward_macaron'
                      else 'norm_ff'))
            linear(p + ff + '.w_1', ffn_units, d)
            linear(p + ff + '.w_2', d, ffn_units)
        norm(p + 'norm_mha')
        for proj in ('linear_q', 'linear_k', 'linear_v', 'linear_out'):
            linear(p + 'self_attn.' + proj, d, d)
        linear(p + 'self_attn.linear_pos', d, d,
               bias=extra.get('pos_bias', False))
        width = extra.get('u_width', d // heads)
        s[p + 'self_attn.pos_bias_u'] = (heads, width)
        s[p + 'self_attn.pos_bias_v'] = (heads, width)
        norm(p + 'norm_conv')
        c = p + 'conv_module.' + extra.get('conv', '')
        linear(c + 'pointwise_conv1', 2 * d, d)
        s[c + 'depthwise_conv.weight'] = (d, 1, kernel)
        s[c + 'depthwise_conv.bias'] = (d,)
        norm(c + 'norm')
        linear(c + 'pointwise_conv2', d, d)
        if block_norm:
            norm(p + 'norm_final')
    norm('encoder.after_norm')
    linear('ctc.ctc_lo', vocab, d)
    return s
