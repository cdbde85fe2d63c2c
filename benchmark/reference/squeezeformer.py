"""Plain float32 reference of the streaming Squeezeformer (PPASR
``configs/squeezeformer.yml``; Kim et al., arXiv:2206.00888): one stream's
encoder driven chunk by chunk, and a zero-padded batch at full context,
with the CTC posteriors of each.

The encoder, as PPASR's ``squeezeformer/encoder.py`` computes it at
inference (no dropout):

- global CMVN; a 3×3 stride-2 convolution and a 3×3 stride-2 convolution
  (depthwise only under ``dw_stride``), each with ReLU, the planes
  flattened feature-major, ×√D, the input projection, then ``preln``;
- blocks of self-attention, feed-forward, convolution module and
  feed-forward, each a residual branch whose input is first scaled by the
  module's ``ada_scale`` and shifted by its ``ada_bias``, and each followed
  by its LayerNorm (post-LN; ``normalize_before`` puts the norm first);
- relative-position attention without a rel-shift, ``linear_pos`` with a
  bias; the causal convolution module of ``blocks.conv_module``;
- a temporal U-Net: before block ``reduce_idx`` the frames are pushed and
  the time axis halved (``'stream'``: a depthwise convolution of kernel 1
  and stride 2, then a pointwise one; the positions and masks keep every
  second frame); before block ``recover_idx`` the frames are repeated ×2,
  projected and added to the pushed frames, cut to their length.

Streaming follows PPASR's ``forward_chunk`` (SURVEY, ``encoder.py:355-373``),
not the port's: every layer keeps one attention cache at the base frame
rate; before a layer of rate factor f its rows are taken ``[::f]`` and cut
to the strided key window less the chunk's frames; after it the layer's
keys and values from frame chunk // f on are repeated ×f along time and
cut to the cache's length. The port instead keeps a ring per layer at the
layer's own rate; the check compares the two formulations. The cache is
of a fixed length with the newest frames last: key slot j of the S =
cache + chunk slots carries the sinusoid row of frame offset − cache + j
(zero before the first frame), and the slots before the stream's first
frame are masked, which is PPASR's growing cache with its rows aligned
right. The convolution caches hold the last kernel − 1 module inputs at
each layer's own rate, as PPASR's do.

Departures, each the model as the port builds it:

- the LayerNorms of the blocks and ``preln`` take eps 1e-6 (PPASR's
  ``torch.nn.LayerNorm`` defaults to 1e-5; the port follows the JAX
  package, flax's default); the convolution module's norm takes 1e-5;
- a stream's last window is zero-padded to the full window, as the
  serving engine pads it, so the padded frames are keys of its valid
  ones (PPASR runs a shorter last chunk); ``Stream.step`` also takes a
  shorter window, whose odd half-rate frame count is kept as PPASR keeps
  it;
- the weights are the harness's seeded draws, not the paper's
  scale-aware initialisation; the layout, one reduction before block
  ``reduce_idx`` and one recovery before block ``recover_idx``, is
  PPASR's configuration of the paper's temporal U-Net.
"""
import math

import torch
import torch.nn.functional as F

from reference import blocks

LN_EPS = 1e-6


def _enc(conf: dict) -> dict:
    return conf['encoder_conf']


def _schedule(conf: dict):
    enc = _enc(conf)
    as_list = lambda v: [] if v is None else (  # noqa: E731
        [v] if isinstance(v, int) else list(v))
    reduce_idx = as_list(enc.get('reduce_idx', 5))
    recover_idx = as_list(enc.get('recover_idx', 11)) if reduce_idx else []
    return reduce_idx, recover_idx


def factor(conf: dict, i: int) -> int:
    """Block i's time reduction against the base frame rate."""
    reduce_idx, recover_idx = _schedule(conf)
    return 2 ** (sum(i >= r for r in reduce_idx)
                 - sum(i >= r for r in recover_idx))


def _widths(conf: dict):
    enc = _enc(conf)
    d = enc.get('encoder_dim', 256)
    return (d, enc.get('attention_heads', 4),
            d * enc.get('feed_forward_expansion_factor', 8),
            enc.get('cnn_module_kernel', 31))


def reduction_kernel(conf: dict) -> int:
    """``'stream'`` (every streaming model) is kernel 1, ``'conv1d'`` 5."""
    if conf.get('streaming', True):
        return 1
    return 1 if _enc(conf).get('time_reduction_layer_type',
                               'conv1d') == 'stream' else 5


def param_shapes(conf: dict) -> dict:
    """{name: shape} of the encoder and CTC head, by the port's names."""
    enc = _enc(conf)
    d, heads, ffn_units, kernel = _widths(conf)
    out = enc.get('output_size', d)
    f2 = ((conf['input_dim'] - 1) // 2 - 1) // 2
    s = {'encoder.embed.pw_conv.weight': (d, 1, 3, 3),
         'encoder.embed.pw_conv.bias': (d,),
         'encoder.embed.dw_conv.weight': (
             d, 1 if enc.get('dw_stride', False) else d, 3, 3),
         'encoder.embed.dw_conv.bias': (d,)}

    def linear(name, n_out, n_in, bias=True):
        s[name + '.weight'] = (n_out, n_in)
        if bias:
            s[name + '.bias'] = (n_out,)

    def norm(name):
        s[name + '.weight'] = (d,)
        s[name + '.bias'] = (d,)

    def ada(name):
        s[name + '.ada_scale'] = (1, 1, d)
        s[name + '.ada_bias'] = (1, 1, d)

    linear('encoder.input_proj', d, f2 * d)
    norm('encoder.preln')
    for i in range(enc.get('num_blocks', 12)):
        p = f'encoder.layers.{i}.'
        for k in range(1, 5):
            norm(f'{p}layer_norm{k}')
        a = p + 'self_attn'
        s[a + '.pos_bias_u'] = (heads, d // heads)
        s[a + '.pos_bias_v'] = (heads, d // heads)
        ada(a)
        for proj in ('linear_q', 'linear_k', 'linear_v', 'linear_out',
                     'linear_pos'):
            linear(f'{a}.{proj}', d, d)
        for ff in ('ffn1', 'ffn2'):
            ada(p + ff)
            linear(f'{p}{ff}.w_1', ffn_units, d)
            linear(f'{p}{ff}.w_2', d, ffn_units)
        c = p + 'conv_module'
        ada(c)
        linear(c + '.pointwise_conv1', 2 * d, d)
        s[c + '.depthwise_conv.weight'] = (d, 1, kernel)
        s[c + '.depthwise_conv.bias'] = (d,)
        norm(c + '.norm')
        linear(c + '.pointwise_conv2', d, d)
    s['encoder.time_reduction_layer.dw_conv.weight'] = (
        d, 1, reduction_kernel(conf))
    s['encoder.time_reduction_layer.dw_conv.bias'] = (d,)
    linear('encoder.time_reduction_layer.pw_conv', d, d)
    linear('encoder.time_recover_layer', d, d)
    if out != d:
        linear('encoder.final_proj', out, d)
    linear('ctc.ctc_lo', conf['vocab_size'], out)
    return s


# ------------------------------------------------------------ the blocks

def subsample(W, x, cmvn, conf):
    """[B, T, 80] features → [B, ((T − 1) // 2 − 1) // 2, D], after
    ``preln``."""
    d = _widths(conf)[0]
    mean, istd = cmvn
    x = ((x - mean) * istd)[:, None]
    x = F.relu(F.conv2d(x, W['encoder.embed.pw_conv.weight'],
                        W['encoder.embed.pw_conv.bias'], stride=2))
    x = F.relu(F.conv2d(x, W['encoder.embed.dw_conv.weight'],
                        W['encoder.embed.dw_conv.bias'], stride=2,
                        groups=d // W['encoder.embed.dw_conv.weight']
                        .shape[1]))
    b, c, t, f = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, t, f * c) * math.sqrt(d)
    return blocks.layer_norm(W, 'encoder.preln',
                             blocks.lin(W, 'encoder.input_proj', x), LN_EPS)


def ada(W, name, x):
    return x * W[name + '.ada_scale'] + W[name + '.ada_bias']


def layer(W, conf, i, x, pos, mask, kv, conv_cache, valid=None):
    """Block i over x [B, T, D]: pos [1|B, S, D] rows of the S keys, mask
    [B, 1|T, S], kv the (k, v) cache [B, S − T, H, dk] or None, conv_cache
    [B, K − 1, D] or None, valid [B, T] frames (full context) or None →
    (x, (k, v) of all S keys, the new conv cache)."""
    _, heads, _, kernel = _widths(conf)
    p = f'encoder.layers.{i}.'
    pre = bool(_enc(conf).get('normalize_before', False))

    def branch(x, k, fn):
        norm = f'{p}layer_norm{k}'
        y, extra = fn(blocks.layer_norm(W, norm, x, LN_EPS) if pre else x)
        x = x + y
        return (x if pre else blocks.layer_norm(W, norm, x, LN_EPS)), extra

    x, kv = branch(x, 1, lambda y: blocks.rel_attention(
        W, p + 'self_attn', ada(W, p + 'self_attn', y), pos, mask, heads, kv))
    x, _ = branch(x, 2, lambda y: (
        blocks.ffn(W, p + 'ffn1', ada(W, p + 'ffn1', y)), None))
    x, conv_cache = branch(x, 3, lambda y: blocks.conv_module(
        W, p + 'conv_module', ada(W, p + 'conv_module', y), kernel,
        mask=valid, cache=conv_cache))
    x, _ = branch(x, 4, lambda y: (
        blocks.ffn(W, p + 'ffn2', ada(W, p + 'ffn2', y)), None))
    return x, kv, conv_cache


def time_reduce(W, x, valid=None):
    """The stride-2 time reduction: padded frames zeroed, a depthwise
    convolution (kernel 1: a scale and a bias per channel of every second
    frame; kernel 5: padding 3 on both sides), a pointwise one."""
    if valid is not None:
        x = x * valid[..., None]
    w = W['encoder.time_reduction_layer.dw_conv.weight']
    k = w.shape[-1]
    pad = max(0, k - 2) if k > 1 else 0
    y = F.conv1d(F.pad(x.transpose(1, 2), (pad, pad)), w,
                 W['encoder.time_reduction_layer.dw_conv.bias'], stride=2,
                 groups=x.shape[2]).transpose(1, 2)
    return blocks.lin(W, 'encoder.time_reduction_layer.pw_conv', y)


def time_recover(W, x, skip):
    y = blocks.lin(W, 'encoder.time_recover_layer',
                   torch.repeat_interleave(x, 2, dim=1))
    return skip + y[:, :skip.shape[1]]


def head(W, x):
    if 'encoder.final_proj.weight' in W:
        x = blocks.lin(W, 'encoder.final_proj', x)
    return blocks.ctc_probs(W, x)


# ------------------------------------------------------------ streaming

class Stream:
    """One stream's encoder state; ``step`` runs one window."""

    def __init__(self, W, cmvn, conf: dict, cache: int, device):
        self.W, self.cmvn, self.conf, self.cache = W, cmvn, conf, cache
        d, self.heads, _, kernel = _widths(conf)
        self.n = _enc(conf).get('num_blocks', 12)
        self.pe = blocks.sinusoids(d, 5000, device)
        dk = d // self.heads
        z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        self.k = [z(1, cache, self.heads, dk) for _ in range(self.n)]
        self.v = [z(1, cache, self.heads, dk) for _ in range(self.n)]
        self.conv = [z(1, kernel - 1, d) for _ in range(self.n)]
        self.offset = 0
        self.valid = 0

    def step(self, window: torch.Tensor) -> torch.Tensor:
        """[T_in, 80] window → [chunk, V] posteriors."""
        W, c, conf = self.W, self.cache, self.conf
        x = subsample(W, window[None], self.cmvn, conf)
        t = x.shape[1]
        s = c + t
        idx = torch.arange(s, device=x.device) + self.offset - c
        pos = self.pe[idx.clamp(min=0)] * (idx >= 0)[:, None]
        keys = torch.arange(s, device=x.device) >= c - self.valid
        reduce_idx, recover_idx = _schedule(conf)
        stack = []
        for i in range(self.n):
            f = factor(conf, i)
            if i in reduce_idx:
                stack.append(x)
                x = time_reduce(W, x)
            if i in recover_idx and stack:
                x = time_recover(W, x, stack.pop())
            pos_i, keys_i = pos[::f], keys[::f]
            n_cache = pos_i.shape[0] - x.shape[1]
            kv = (self.k[i][:, ::f][:, :n_cache],
                  self.v[i][:, ::f][:, :n_cache])
            x, (k, v), self.conv[i] = layer(
                W, conf, i, x, pos_i[None], keys_i[None, None], kv,
                self.conv[i])
            self.k[i] = torch.repeat_interleave(k[:, t // f:], f, 1)[:, :c]
            self.v[i] = torch.repeat_interleave(v[:, t // f:], f, 1)[:, :c]
        self.offset += t
        self.valid = min(self.valid + t, c)
        return head(W, x)[0]


# ------------------------------------------------------------ full context

def forward(W, cmvn, conf, feats, lens):
    """feats [B, T, 80] padded log-mel, lens [B] valid frames →
    (posteriors [B, T', V], valid output frames [B])."""
    d = _widths(conf)[0]
    x = subsample(W, feats, cmvn, conf)
    t = x.shape[1]
    out_lens = ((lens - 1) // 2 - 1) // 2
    valid = torch.arange(t, device=x.device)[None] < out_lens[:, None]
    pos = blocks.sinusoids(d, t, x.device)[None]
    reduce_idx, recover_idx = _schedule(conf)
    stack = []
    for i in range(_enc(conf).get('num_blocks', 12)):
        if i in reduce_idx:
            stack.append((x, pos, valid))
            x = time_reduce(W, x, valid)
            pos, valid = pos[:, ::2], valid[:, ::2]
            x = x[:, :valid.shape[1]]
        if i in recover_idx and stack:
            skip, pos, valid = stack.pop()
            x = time_recover(W, x, skip)
        x, _, _ = layer(W, conf, i, x, pos, valid[:, None], None, None,
                        valid)
    return head(W, x), out_lens
