"""Squeezeformer: a post-LN encoder that halves the time axis in its middle
blocks and restores it before the last (counterpart of
ppasr_tpu/models/squeezeformer.py).

- ``DepthwiseConv2DSubsampling4`` (:51-75): a 3×3 stride-2 conv and a 3×3
  stride-2 (optionally depthwise) conv with ReLU, flattened (f, c); the
  encoder's ``input_proj`` follows the ×sqrt(d) scale.
- ``TimeReductionLayer1D`` (:77-98): depthwise conv k=5, stride 2, padding
  3 on both sides, then a pointwise linear; ``TimeReductionLayerStream``
  (:100-117): k=1, stride 2 (no cache), for streaming models.
- ``SqueezeformerEncoderLayer`` (:119-190): MHSA → FFN → conv → FFN, each
  with a residual and, by default, a LayerNorm after it (eps 1e-6); the
  adaptive scales and the scale-aware init of the attention, FFNs and conv
  module.
- ``SqueezeformerEncoder.forward`` (:325-371): preln, then at each
  ``reduce_idx`` block the stream, its masks and positions are pushed and
  the time axis halved (``[:, ::2]`` on masks and positions, the output
  clipped to the strided mask, the odd-length case); at ``recover_idx``
  the frames are repeated ×2, projected (``time_recover_layer``) and added
  to the pushed stream, cut to its length. While a profiler records
  (``utils/trace``), ``forward`` and ``forward_chunk`` record
  ``encoder.half_rate`` from each time reduction through its recovery's
  residual add (or the last block, where none follows).
- ``forward_chunk`` (:373-465) with ``SqueezeformerState``: per-layer
  static ring caches of ``C // factor(i)`` rows at each layer's time
  scale; the positions of layer i are the base window at stride
  ``factor(i)``, aligned to its tail.
- ``SqueezeformerModel`` (:467-639): the Conformer's CTC + attention
  model around this encoder; streaming switches to the ``'stream'`` time
  reduction, dynamic chunks and causal convs (:505-510).
"""
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.models.attention import MultiHeadedAttention
from ppasr_tpu_torch.models.base import (Conv1d, Conv2d, Dropout, GlobalCMVN,
                                         LayerNorm, Linear, compute_dtype_of,
                                         dtype_scalar, get_activation)
from ppasr_tpu_torch.models.conformer import ConformerModel
from ppasr_tpu_torch.models.convolution import ConvolutionModule
from ppasr_tpu_torch.models.embedding import chunk_positions, sinusoid_table
from ppasr_tpu_torch.models.positionwise import PositionwiseFeedForward
from ppasr_tpu_torch.models.subsampling import flatten_nhwc, subsampled_len4
from ppasr_tpu_torch.ops.masks import add_optional_chunk_mask, make_non_pad_mask
from ppasr_tpu_torch.utils.trace import span


class SqueezeformerState(NamedTuple):
    """Streaming state: per-layer caches at each layer's own time scale."""
    offset: torch.Tensor              # [B] int32, base-scale frames consumed
    cache_len: torch.Tensor           # [B] int32, base-scale valid frames
    att_k: Tuple[torch.Tensor, ...]   # layer i: [B, C // factor(i), H, dk]
    att_v: Tuple[torch.Tensor, ...]
    cnn_cache: Tuple[torch.Tensor, ...]  # layer i: [B, lorder, D]

    def stream_axes(self):
        return type(self)(0, 0, *(tuple(0 for _ in f) for f in self[2:]))


def half_rate_span():
    """``encoder.half_rate``, entered here and left by the caller at the
    recovery's residual add."""
    s = span('encoder.half_rate')
    s.__enter__()
    return s


def as_list(v) -> Optional[List[int]]:
    if v is None:
        return None
    return [v] if isinstance(v, int) else list(v)


class DepthwiseConv2DSubsampling4(nn.Module):
    subsampling_rate = 4
    right_context = 6

    def __init__(self, odim: int, dw_stride: bool = False):
        super().__init__()
        self.pw_conv = Conv2d(1, odim, 3, stride=2)
        self.dw_conv = Conv2d(odim, odim, 3, stride=2,
                              groups=odim if dw_stride else 1)

    def forward(self, x):
        x = F.relu(self.pw_conv(x[:, None]))
        return flatten_nhwc(F.relu(self.dw_conv(x)))


class TimeReductionLayer(nn.Module):
    """Depthwise conv over time with ``stride`` and padding ``pad`` on both
    sides, then the pointwise linear: k=5, pad 3 is
    ``TimeReductionLayer1D``, k=1, pad 0 ``TimeReductionLayerStream``."""

    def __init__(self, channel: int, kernel_size: int = 5, stride: int = 2):
        super().__init__()
        self.pad = max(0, kernel_size - stride) if kernel_size > 1 else 0
        self.dw_conv = Conv1d(channel, channel, kernel_size, stride=stride,
                              groups=channel)
        self.pw_conv = Linear(channel, channel)

    def forward(self, x, mask_pad=None):
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        y = F.pad(x.transpose(1, 2), (self.pad, self.pad))
        return self.pw_conv(self.dw_conv(y).transpose(1, 2))


class SqueezeformerEncoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int,
                 feed_forward_units: int, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.1,
                 normalize_before: bool = False, cnn_module_kernel: int = 31,
                 cnn_norm_type: str = 'layer_norm', causal: bool = False,
                 adaptive_scale: bool = True, activation=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout = Dropout(dropout_rate)
        for k in range(1, 5):
            setattr(self, f'layer_norm{k}', LayerNorm(size, eps=1e-6))
        self.self_attn = MultiHeadedAttention(
            attention_heads, size, rel_pos=True,
            dropout_rate=attention_dropout_rate,
            adaptive_scale=adaptive_scale, pos_bias=True, init_weights=True)
        ffn = lambda: PositionwiseFeedForward(  # noqa: E731
            size, feed_forward_units, activation, dropout_rate,
            adaptive_scale=adaptive_scale, init_weights=True)
        self.ffn1, self.ffn2 = ffn(), ffn()
        self.conv_module = ConvolutionModule(
            size, cnn_module_kernel, activation, cnn_norm_type, causal,
            adaptive_scale=adaptive_scale, init_weights=True)

    def _sublayer(self, x, norm, fn):
        y, extra = fn(norm(x) if self.normalize_before else x)
        x = x + self.dropout(y)
        return (x if self.normalize_before else norm(x)), extra

    def forward(self, x, mask, pos_emb, mask_pad=None, kv_cache=None,
                cnn_cache=None):
        x, new_kv = self._sublayer(
            x, self.layer_norm1,
            lambda y: self.self_attn(y, y, y, mask=mask, pos_emb=pos_emb,
                                     kv_cache=kv_cache))
        x, _ = self._sublayer(x, self.layer_norm2,
                              lambda y: (self.ffn1(y), None))
        x, new_cnn = self._sublayer(
            x, self.layer_norm3,
            lambda y: self.conv_module(y, mask_pad, cnn_cache))
        x, _ = self._sublayer(x, self.layer_norm4,
                              lambda y: (self.ffn2(y), None))
        return x, new_kv, new_cnn


class SqueezeformerEncoder(nn.Module):
    subsampling_rate = 4
    right_context = 6
    out_len = staticmethod(subsampled_len4)

    def __init__(self, input_size: int, encoder_dim: int = 256,
                 output_size: int = 256, attention_heads: int = 4,
                 num_blocks: int = 12,
                 reduce_idx: Union[int, List[int], None] = 5,
                 recover_idx: Union[int, List[int], None] = 11,
                 feed_forward_expansion_factor: int = 8,
                 dw_stride: bool = False, input_dropout_rate: float = 0.1,
                 pos_enc_layer_type: str = 'rel_pos',
                 time_reduction_layer_type: str = 'conv1d',
                 feed_forward_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.1,
                 cnn_module_kernel: int = 31,
                 cnn_norm_type: str = 'layer_norm', dropout: float = 0.1,
                 causal: bool = False, adaptive_scale: bool = True,
                 activation_type: str = 'swish',
                 normalize_before: bool = False,
                 use_dynamic_chunk: bool = False, static_chunk_size: int = 0,
                 use_dynamic_left_chunk: bool = False, max_len: int = 5000,
                 cmvn_mean: Optional[tuple] = None,
                 cmvn_istd: Optional[tuple] = None):
        super().__init__()
        self.encoder_dim, self.output_size = encoder_dim, output_size
        self.attention_heads, self.num_blocks = attention_heads, num_blocks
        self.reduce_idx = as_list(reduce_idx)
        self.recover_idx = as_list(recover_idx)
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.static_chunk_size = static_chunk_size
        self.lorder = cnn_module_kernel - 1 if causal else 0
        self.global_cmvn = (GlobalCMVN(cmvn_mean, cmvn_istd)
                            if cmvn_mean is not None else None)
        self.embed = DepthwiseConv2DSubsampling4(encoder_dim, dw_stride)
        f_out = ((input_size - 1) // 2 - 1) // 2
        self.input_proj = Linear(
            f_out * encoder_dim, encoder_dim,
            init_bound=(encoder_dim * input_size / 4) ** -0.5)
        self.input_dropout = Dropout(input_dropout_rate)
        self.preln = LayerNorm(encoder_dim, eps=1e-6)
        act = get_activation(activation_type)
        self.layers = nn.ModuleList([SqueezeformerEncoderLayer(
            encoder_dim, attention_heads,
            encoder_dim * feed_forward_expansion_factor, dropout,
            attention_dropout_rate, normalize_before, cnn_module_kernel,
            cnn_norm_type, causal, adaptive_scale, act)
            for _ in range(num_blocks)])
        self.time_reduction_layer = TimeReductionLayer(
            encoder_dim, 1 if time_reduction_layer_type == 'stream' else 5)
        self.time_recover_layer = Linear(encoder_dim, encoder_dim)
        if output_size != encoder_dim:
            self.final_proj = Linear(encoder_dim, output_size)
        self.register_buffer(
            'pe', torch.from_numpy(sinusoid_table(encoder_dim, max_len)),
            persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype_of(self.input_proj)

    def factor(self, i: int) -> int:
        """Time downsampling factor of layer i (:213-221)."""
        if self.reduce_idx is None:
            return 1
        reduce_exp = sum(1 for r in self.reduce_idx if i >= r)
        recover_exp = sum(1 for r in (self.recover_idx or []) if i >= r)
        return int(2 ** (reduce_exp - recover_exp))

    def _embed_and_project(self, xs):
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs = self.embed(xs.to(self.dtype))
        xs = xs * dtype_scalar(np.sqrt(self.encoder_dim), xs.dtype)
        return self.input_dropout(self.input_proj(xs))

    def _finish(self, xs):
        return self.final_proj(xs) if self.output_size != self.encoder_dim \
            else xs

    def _schedule(self):
        return (self.reduce_idx or [],
                (self.recover_idx or []) if self.reduce_idx is not None
                else [])

    def forward(self, xs, xs_lens, decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, chunk_generator=None):
        """Full-utterance forward → (out [B, T', D], masks [B, 1, T'])."""
        xs = self._embed_and_project(xs)
        t_sub = xs.shape[1]
        pos_emb = self.pe[None, :t_sub].to(self.dtype)
        masks = make_non_pad_mask(self.out_len(xs_lens.to(torch.long)),
                                  t_sub)[:, None, :]
        mask_pad = masks
        dcs = decoding_chunk_size
        if self.use_dynamic_chunk and dcs == 0 and not self.training:
            dcs = -1
        chunk_masks = add_optional_chunk_mask(
            t_sub, masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            dcs, self.static_chunk_size, num_decoding_left_chunks,
            generator=chunk_generator)
        xs = self.preln(xs)
        reduce_idx, recover_idx = self._schedule()
        stack = []
        for i, layer in enumerate(self.layers):
            if i in reduce_idx:
                stack.append((xs, chunk_masks, pos_emb, mask_pad,
                              half_rate_span()))
                xs = self.time_reduction_layer(xs, mask_pad)
                chunk_masks = chunk_masks[:, ::2, ::2]
                mask_pad = mask_pad[:, :, ::2]
                pos_emb = pos_emb[:, ::2, :]
                xs = xs[:, :mask_pad.shape[-1], :]
            if i in recover_idx and stack:
                r_x, chunk_masks, pos_emb, mask_pad, half = stack.pop()
                xs = self.time_recover_layer(
                    torch.repeat_interleave(xs, 2, dim=1))
                xs = r_x + xs[:, :r_x.shape[1], :]
                half.__exit__(None, None, None)
            xs, _, _ = layer(xs, chunk_masks, pos_emb, mask_pad=mask_pad)
        for *_, half in reversed(stack):
            half.__exit__(None, None, None)
        return self._finish(xs), masks

    def init_state(self, batch_size: int, cache_size: int,
                   device=None) -> SqueezeformerState:
        h = self.attention_heads
        dk = self.encoder_dim // h
        device = device if device is not None else self.pe.device
        z = lambda *s: torch.zeros(s, device=device,  # noqa: E731
                                   dtype=self.dtype)
        sizes = [max(cache_size // self.factor(i), 1)
                 for i in range(self.num_blocks)]
        return SqueezeformerState(
            offset=torch.zeros(batch_size, dtype=torch.int32, device=device),
            cache_len=torch.zeros(batch_size, dtype=torch.int32,
                                  device=device),
            att_k=tuple(z(batch_size, c, h, dk) for c in sizes),
            att_v=tuple(z(batch_size, c, h, dk) for c in sizes),
            cnn_cache=tuple(z(batch_size, self.lorder, self.encoder_dim)
                            for _ in sizes))

    def forward_chunk(self, xs, state: SqueezeformerState):
        """One streaming chunk → (out [B, T_out, D], new_state)."""
        c = state.att_k[0].shape[1]
        xs = self._embed_and_project(xs)
        b, t_out = xs.shape[0], xs.shape[1]
        pos_base = chunk_positions(self.pe.to(self.dtype),
                                   state.offset.reshape(-1).expand(b), c,
                                   c + t_out)
        cache_len = state.cache_len.reshape(-1).expand(b).to(torch.long)
        cur = self.preln(xs)
        reduce_idx, recover_idx = self._schedule()
        stack, new_k, new_v, new_cnn = [], [], [], []
        for i, layer in enumerate(self.layers):
            f = self.factor(i)
            if i in reduce_idx:
                stack.append((cur, half_rate_span()))
                cur = self.time_reduction_layer(cur)
            if i in recover_idx and stack:
                r_x, half = stack.pop()
                cur = self.time_recover_layer(
                    torch.repeat_interleave(cur, 2, dim=1))
                cur = r_x + cur[:, :r_x.shape[1], :]
                half.__exit__(None, None, None)
            c_i = state.att_k[i].shape[1]
            s_i = c_i + cur.shape[1]
            pos_i = pos_base[:, ::f, :][:, -s_i:, :]
            j = torch.arange(s_i, device=cur.device)[None, None, :]
            att_mask = j >= (c_i - torch.clamp(cache_len // f, max=c_i)
                             )[:, None, None]
            cur, (k_all, v_all), cnn_c = layer(
                cur, att_mask, pos_i,
                kv_cache=(state.att_k[i], state.att_v[i]),
                cnn_cache=state.cnn_cache[i] if self.lorder else None)
            new_k.append(k_all[:, k_all.shape[1] - c_i:])
            new_v.append(v_all[:, v_all.shape[1] - c_i:])
            new_cnn.append(cnn_c if self.lorder else state.cnn_cache[i])
        for _, half in reversed(stack):
            half.__exit__(None, None, None)
        new_state = SqueezeformerState(
            offset=state.offset + t_out,
            cache_len=torch.clamp(state.cache_len + t_out, max=c),
            att_k=tuple(new_k), att_v=tuple(new_v),
            cnn_cache=tuple(new_cnn))
        return self._finish(cur), new_state


class SqueezeformerModel(ConformerModel):
    """The hybrid CTC + attention model around ``SqueezeformerEncoder``."""
    encoder_class = SqueezeformerEncoder

    @staticmethod
    def encoder_conf_for(conf: dict, streaming: bool) -> dict:
        conf = dict(conf)
        if streaming:
            conf.update(use_dynamic_chunk=True, causal=True,
                        time_reduction_layer_type='stream')
        return conf
