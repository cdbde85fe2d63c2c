"""EfficientConformer: a Conformer whose time axis shrinks at strided
layers, with grouped attention in the early ones (counterpart of
ppasr_tpu/models/efficient_conformer.py).

- ``Conv2dSubsampling2`` (:49-71): one 3×3 stride-2 VALID conv and a
  linear layer, ×2 (``input_layer: conv2d2``).
- ``GroupedRelPositionAttention`` (:73-163): Transformer-XL attention over
  groups of ``group_size`` frames: queries, keys, values and positions
  padded at the end to a multiple of g and folded to [T/g, H, dk·g], the
  mask strided ``[::g, ::g]``, scores over sqrt(dk·g), ``pos_bias_u/v`` of
  shape [H, dk·g].
- ``EffConLayer`` (:165-268): the Conformer block (macaron FFN, MHSA, conv
  module, FFN, optional block-final LayerNorm) whose conv module may be
  strided (``StridedConvolutionModule``, :270-325: the depthwise conv
  carries the stride and nothing masks its output; at stride 1 it is the
  plain module, named ``inner``); the residual around a strided conv goes
  through AvgPool(stride, ceil_mode).
- ``EfficientConformerEncoder`` (:333-578): CMVN → input layer → ×sqrt(d)
  (rel-pos positions kept apart) → blocks, masks and positions strided
  after each ``stride_layer_idx`` layer and the stream clipped to them;
  ``stride_kernel`` halves the conv kernel after each stride (:399-405);
  ``forward_chunk`` with ``EffConState``: per-layer static ring caches of
  ``C // factor(i)`` rows and per-segment conv caches, positions at each
  layer's stride aligned to the tail of the base window.
- ``EfficientConformerModel`` (:580-780): the Conformer's CTC + attention
  model around this encoder; ``encoder_conf``'s nested ``efficient_conf``
  is flattened into it (:604-611) and ``output_factor`` is the product of
  the strides (:771-780).
"""
import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.models.attention import (MultiHeadedAttention,
                                              attention_inputs)
from ppasr_tpu_torch.models.base import (Conv1d, Dropout, GlobalCMVN,
                                         LayerNorm, Linear, compute_dtype_of,
                                         dtype_scalar, get_activation, swish)
from ppasr_tpu_torch.models.conformer import ConformerModel
from ppasr_tpu_torch.models.convolution import ConvolutionModule, make_norm
from ppasr_tpu_torch.models.embedding import chunk_positions, sinusoid_table
from ppasr_tpu_torch.models.positionwise import PositionwiseFeedForward
from ppasr_tpu_torch.models.subsampling import (SUBSAMPLING_CLASSES,
                                                _ConvSubsampling)
from ppasr_tpu_torch.ops.masks import add_optional_chunk_mask, make_non_pad_mask
from ppasr_tpu_torch.parallel.tensor_parallel import copy_to_model


class EffConState(NamedTuple):
    offset: torch.Tensor              # [B] int32 (per stream)
    cache_len: torch.Tensor           # [B] int32
    att_k: Tuple[torch.Tensor, ...]   # layer i: [B, C // factor(i), H, dk]
    att_v: Tuple[torch.Tensor, ...]
    cnn_cache: Tuple[torch.Tensor, ...]  # layer i: [B, lorder_i, D]

    def stream_axes(self):
        return type(self)(0, 0, *(tuple(0 for _ in f) for f in self[2:]))


def as_list(v) -> list:
    if v is None:
        return []
    return [v] if isinstance(v, int) else list(v)


class Conv2dSubsampling2(_ConvSubsampling):
    CONVS = ((3, 2),)
    subsampling_rate = 2
    right_context = 2

    @staticmethod
    def out_len(t):
        return (t - 1) // 2


def _pad_time(x, g):
    """x [B, T, ...] padded with zeros at the end of T to a multiple of g
    → (x, pad)."""
    # ⌈T/g⌉·g − T with no branch on it: under a symbolic T (torch.export)
    # the padded length stays the plain product ⌈T/g⌉·g
    pad = (x.shape[1] + g - 1) // g * g - x.shape[1]
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad)), pad


def _every(x, dim: int, g: int):
    """``x`` at every g-th index of ``dim`` (``x[..., ::g]``) as a fresh
    tensor: a strided view's strides under a symbolic length make
    torch.export guard on the length's residue."""
    return x.index_select(dim, torch.arange(0, x.shape[dim], g,
                                            device=x.device))


def _first(x, dim: int, n: int):
    """The first ``n`` indices of ``dim`` as a fresh tensor (see
    ``_every``)."""
    return x.index_select(dim, torch.arange(n, device=x.device))


def _group(x, g):
    """[B, T, H, dk] → [B, T/g, H, g·dk]."""
    b, t, h, dk = x.shape
    return x.reshape(b, t // g, g, h, dk).permute(0, 1, 3, 2, 4) \
        .reshape(b, t // g, h, g * dk)


class GroupedRelPositionAttention(nn.Module):
    tp = None

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 group_size: int = 3):
        super().__init__()
        self.n_head, self.n_feat, self.group_size = n_head, n_feat, group_size
        self.d_k = n_feat // n_head
        for name in ('linear_q', 'linear_k', 'linear_v', 'linear_out',
                     'linear_pos'):
            setattr(self, name, Linear(n_feat, n_feat))
        self.dropout = Dropout(dropout_rate)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head,
                                                   self.d_k * group_size))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head,
                                                   self.d_k * group_size))

    def _heads(self, x, proj):
        return proj(x).view(x.shape[0], x.shape[1], self.n_head, self.d_k)

    def forward(self, query, key, value, mask=None, pos_emb=None,
                kv_cache=None):
        """As ``MultiHeadedAttention.forward`` with rel-pos."""
        g, b = self.group_size, query.shape[0]
        query, key, value = attention_inputs(self, query, key, value)
        q = self._heads(query, self.linear_q)
        k = self._heads(key, self.linear_k)
        v = self._heads(value, self.linear_v)
        if kv_cache is not None:
            k = torch.cat([kv_cache[0], k], dim=1)
            v = torch.cat([kv_cache[1], v], dim=1)
        new_cache = (k, v)
        p = self._heads(pos_emb, self.linear_pos)

        q, pad_q = _pad_time(q, g)
        qg, kg, vg, pg = (_group(x, g) for x in
                          (q, _pad_time(k, g)[0], _pad_time(v, g)[0],
                           _pad_time(p, g)[0]))
        matrix_ac = torch.einsum('bthd,bshd->bhts',
                                 qg + self.pos_bias_u.to(qg.dtype), kg)
        matrix_bd = torch.einsum('bthd,bshd->bhts',
                                 qg + self.pos_bias_v.to(qg.dtype),
                                 pg.expand(b, -1, -1, -1))
        scores = (matrix_ac + matrix_bd) / math.sqrt(self.d_k * g)
        if mask is not None:
            m = _every(mask, 2, g)
            m = _every(m, 1, g) if mask.shape[1] > 1 else m
            m = m[:, None, :, :scores.shape[-1]]
            scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min / 2)
            attn = torch.softmax(scores, dim=-1).masked_fill(~m, 0.0)
        else:
            attn = torch.softmax(scores, dim=-1)
        x = torch.einsum('bhts,bshd->bthd', self.dropout(attn), vg)
        t1g = x.shape[1]
        x = x.reshape(b, t1g, self.n_head, g, self.d_k) \
            .permute(0, 1, 3, 2, 4).reshape(b, t1g * g, self.n_feat)
        x = _first(x, 1, x.shape[1] - pad_q)
        return self.linear_out(x), new_cache


class StridedConvolutionModule(nn.Module):
    tp = None

    def __init__(self, channels: int, kernel_size: int = 15,
                 activation=swish, norm: str = 'layer_norm',
                 causal: bool = False, stride: int = 1):
        super().__init__()
        self.stride, self.kernel_size, self.causal = stride, kernel_size, causal
        self.lorder = kernel_size - 1 if causal else 0
        if stride == 1:
            self.inner = ConvolutionModule(channels, kernel_size, activation,
                                           norm, causal)
            return
        self.activation = activation
        self.pointwise_conv1 = Linear(channels, 2 * channels)
        self.depthwise_conv = Conv1d(channels, channels, kernel_size,
                                     stride=stride, groups=channels)
        self.norm = make_norm(norm, channels)
        self.pointwise_conv2 = Linear(channels, channels)

    def forward(self, x, mask_pad=None, cache=None):
        if self.stride == 1:
            return self.inner(x, mask_pad, cache)
        if mask_pad is not None:
            x = x.masked_fill(~mask_pad.transpose(1, 2), 0.0)
        if self.causal:
            pad = cache if cache is not None else x.new_zeros(
                x.shape[0], self.lorder, x.shape[2])
            x = torch.cat([pad, x], dim=1)
            new_cache = x[:, x.shape[1] - self.lorder:, :]
        else:
            new_cache = x.new_zeros(x.shape[0], 0, x.shape[2])
        y = self.pointwise_conv1(copy_to_model(x, self.tp))
        a, b = y.chunk(2, dim=-1)
        y = (a * torch.sigmoid(b)).transpose(1, 2)
        if not self.causal:
            half = (self.kernel_size - 1) // 2
            y = F.pad(y, (half, half))
        y = self.depthwise_conv(y).transpose(1, 2)
        return self.pointwise_conv2(self.activation(self.norm(y))), new_cache


def avg_pool_ceil(x, s: int):
    """AvgPool1d(s, ceil_mode=True) over the time axis of [B, T, D]: the
    last window averages the frames it has."""
    t = x.shape[1]
    tg = (t + s - 1) // s
    x = F.pad(x, (0, 0, 0, tg * s - t))
    starts = torch.arange(0, tg * s, s, device=x.device)
    denom = (torch.clamp(starts + s, max=t) - starts).clamp(min=1)
    return x.reshape(x.shape[0], tg, s, x.shape[2]).sum(2) \
        / denom[None, :, None].to(x.dtype)


class EffConLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 normalize_before: bool = True, macaron_style: bool = True,
                 cnn_module_kernel: int = 15,
                 cnn_module_norm: str = 'layer_norm', causal: bool = False,
                 activation=swish, final_norm: bool = True,
                 grouped: bool = False, group_size: int = 3, stride: int = 1):
        super().__init__()
        self.normalize_before, self.macaron_style = normalize_before, \
            macaron_style
        self.final_norm, self.stride = final_norm, stride
        self.dropout = Dropout(dropout_rate)
        ln = lambda: LayerNorm(size, eps=1e-5)  # noqa: E731
        if macaron_style:
            self.norm_ff_macaron = ln()
            self.feed_forward_macaron = PositionwiseFeedForward(
                size, linear_units, activation, dropout_rate)
        self.norm_mha = ln()
        self.self_attn = GroupedRelPositionAttention(
            attention_heads, size, attention_dropout_rate, group_size) \
            if grouped else MultiHeadedAttention(
                attention_heads, size, rel_pos=True,
                dropout_rate=attention_dropout_rate)
        self.norm_conv = ln()
        self.conv_module = StridedConvolutionModule(
            size, cnn_module_kernel, activation, cnn_module_norm, causal,
            stride)
        self.norm_ff = ln()
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, activation, dropout_rate)
        if final_norm:
            self.norm_final = ln()

    def _sublayer(self, x, norm, fn, scale=1.0, residual=None):
        y, extra = fn(norm(x) if self.normalize_before else x)
        x = (x if residual is None else residual) + scale * self.dropout(y)
        if not self.normalize_before:
            x = norm(x)
        return x, extra

    def forward(self, x, mask, pos_emb, mask_pad=None, kv_cache=None,
                cnn_cache=None):
        ff_scale = 0.5 if self.macaron_style else 1.0
        if self.macaron_style:
            x, _ = self._sublayer(
                x, self.norm_ff_macaron,
                lambda y: (self.feed_forward_macaron(y), None), ff_scale)
        x, new_kv = self._sublayer(
            x, self.norm_mha,
            lambda y: self.self_attn(y, y, y, mask=mask, pos_emb=pos_emb,
                                     kv_cache=kv_cache))
        x, new_cnn = self._sublayer(
            x, self.norm_conv,
            lambda y: self.conv_module(y, mask_pad, cnn_cache),
            residual=avg_pool_ceil(x, self.stride) if self.stride > 1
            else None)
        x, _ = self._sublayer(x, self.norm_ff,
                              lambda y: (self.feed_forward(y), None), ff_scale)
        if self.final_norm:
            x = self.norm_final(x)
        return x, new_kv, new_cnn


class EfficientConformerEncoder(nn.Module):
    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 12, dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 input_layer: str = 'conv2d',
                 pos_enc_layer_type: str = 'rel_pos',
                 normalize_before: bool = True, static_chunk_size: int = 0,
                 use_dynamic_chunk: bool = False,
                 use_dynamic_left_chunk: bool = False,
                 macaron_style: bool = True, activation_type: str = 'swish',
                 use_cnn_module: bool = True, cnn_module_kernel: int = 15,
                 causal: bool = False, cnn_module_norm: str = 'layer_norm',
                 stride_layer_idx: Union[int, List[int]] = 3,
                 stride: Union[int, List[int]] = 2,
                 group_layer_idx: Union[int, List[int], tuple] = (0, 1, 2, 3),
                 group_size: int = 3, stride_kernel: bool = True,
                 max_len: int = 5000, cmvn_mean: Optional[tuple] = None,
                 cmvn_istd: Optional[tuple] = None,
                 block_final_norm: bool = True):
        super().__init__()
        self.output_size, self.attention_heads = output_size, attention_heads
        self.num_blocks, self.normalize_before = num_blocks, normalize_before
        self.static_chunk_size = static_chunk_size
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.stride_idx, self.strides = as_list(stride_layer_idx), \
            as_list(stride)
        self.causal = causal
        self.global_cmvn = (GlobalCMVN(cmvn_mean, cmvn_istd)
                            if cmvn_mean is not None else None)
        sub = Conv2dSubsampling2 if input_layer == 'conv2d2' \
            else SUBSAMPLING_CLASSES[input_layer]
        self.subsampling_rate = sub.subsampling_rate
        self.right_context = sub.right_context
        self.out_len = sub.out_len
        self.embed = sub(input_size, output_size)
        self.pos_dropout = Dropout(positional_dropout_rate)
        self.kernels = [cnn_module_kernel]
        for s in self.strides:
            self.kernels.append(self.kernels[-1] // s if stride_kernel
                                else self.kernels[-1])
        act = get_activation(activation_type)
        group_idx = set(as_list(group_layer_idx))
        layers, seg = [], 0
        for i in range(num_blocks):
            is_stride = i in self.stride_idx
            layers.append(EffConLayer(
                output_size, attention_heads, linear_units, dropout_rate,
                attention_dropout_rate, normalize_before, macaron_style,
                self.kernels[seg], cnn_module_norm, causal, act,
                block_final_norm, i in group_idx, group_size,
                self.strides[self.stride_idx.index(i)] if is_stride else 1))
            seg += is_stride
        self.layers = nn.ModuleList(layers)
        if normalize_before:
            self.after_norm = LayerNorm(output_size, eps=1e-5)
        self.register_buffer(
            'pe', torch.from_numpy(sinusoid_table(output_size, max_len)),
            persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype_of(self.embed.Dense_0)

    def factor(self, i: int) -> int:
        """Downsampling factor the input of layer i sees (:385-393)."""
        f = 1
        for s, s_idx in zip(self.strides, self.stride_idx):
            if i > s_idx:
                f *= s
        return f

    def _embed(self, xs):
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        xs = self.embed(xs.to(self.dtype))
        return xs * dtype_scalar(np.sqrt(self.output_size), xs.dtype)

    def forward(self, xs, xs_lens, decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, chunk_generator=None):
        """Full forward → (out [B, T'/factor, D], masks strided alike)."""
        xs = self.pos_dropout(self._embed(xs))
        t_sub = xs.shape[1]
        masks = make_non_pad_mask(self.out_len(xs_lens.to(torch.long)),
                                  t_sub)[:, None, :]
        mask_pad = masks
        pos_emb = self.pe[None, :t_sub].to(self.dtype)
        dcs = decoding_chunk_size
        if self.use_dynamic_chunk and dcs == 0 and not self.training:
            dcs = -1
        chunk_masks = add_optional_chunk_mask(
            t_sub, masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            dcs, self.static_chunk_size, num_decoding_left_chunks,
            generator=chunk_generator)
        for i, layer in enumerate(self.layers):
            xs, _, _ = layer(xs, chunk_masks, pos_emb, mask_pad=mask_pad)
            if i in self.stride_idx:
                s = self.strides[self.stride_idx.index(i)]
                masks = masks[:, :, ::s]
                chunk_masks = chunk_masks[:, ::s, ::s]
                mask_pad = masks
                pos_emb = pos_emb[:, ::s, :]
                xs = xs[:, :mask_pad.shape[-1], :]
        if self.normalize_before:
            xs = self.after_norm(xs)
        return xs, masks

    def _lorders(self):
        out, seg = [], 0
        for i in range(self.num_blocks):
            out.append(self.kernels[seg] - 1 if self.causal else 0)
            seg += i in self.stride_idx
        return out

    def init_state(self, batch_size: int, cache_size: int,
                   device=None) -> EffConState:
        h = self.attention_heads
        dk = self.output_size // h
        device = device if device is not None else self.pe.device
        z = lambda *s: torch.zeros(s, device=device,  # noqa: E731
                                   dtype=self.dtype)
        sizes = [max(cache_size // self.factor(i), 1)
                 for i in range(self.num_blocks)]
        return EffConState(
            offset=torch.zeros(batch_size, dtype=torch.int32, device=device),
            cache_len=torch.zeros(batch_size, dtype=torch.int32,
                                  device=device),
            att_k=tuple(z(batch_size, c, h, dk) for c in sizes),
            att_v=tuple(z(batch_size, c, h, dk) for c in sizes),
            cnn_cache=tuple(z(batch_size, lo, self.output_size)
                            for lo in self._lorders()))

    def forward_chunk(self, xs, state: EffConState):
        """One streaming chunk → (out [B, T_out/factor, D], new_state)."""
        c = state.att_k[0].shape[1]
        cur = self._embed(xs)
        b, t_out = cur.shape[0], cur.shape[1]
        pos_base = chunk_positions(self.pe.to(self.dtype),
                                   state.offset.reshape(-1).expand(b), c,
                                   c + t_out)
        cache_len = state.cache_len.reshape(-1).expand(b).to(torch.long)
        new_k, new_v, new_cnn = [], [], []
        for i, layer in enumerate(self.layers):
            f = self.factor(i)
            c_i = state.att_k[i].shape[1]
            s_i = c_i + cur.shape[1]
            pos_i = pos_base[:, ::f, :][:, -s_i:, :]
            j = torch.arange(s_i, device=cur.device)[None, None, :]
            att_mask = j >= (c_i - torch.clamp(cache_len // f, max=c_i)
                             )[:, None, None]
            has_cache = state.cnn_cache[i].shape[1] > 0
            cur, (k_all, v_all), cnn_c = layer(
                cur, att_mask, pos_i,
                kv_cache=(state.att_k[i], state.att_v[i]),
                cnn_cache=state.cnn_cache[i] if has_cache else None)
            new_k.append(k_all[:, k_all.shape[1] - c_i:])
            new_v.append(v_all[:, v_all.shape[1] - c_i:])
            new_cnn.append(cnn_c if has_cache else state.cnn_cache[i])
        if self.normalize_before:
            cur = self.after_norm(cur)
        new_state = EffConState(
            offset=state.offset + t_out,
            cache_len=torch.clamp(state.cache_len + t_out, max=c),
            att_k=tuple(new_k), att_v=tuple(new_v),
            cnn_cache=tuple(new_cnn))
        return cur, new_state


class EfficientConformerModel(ConformerModel):
    """The hybrid CTC + attention model around
    ``EfficientConformerEncoder``."""
    encoder_class = EfficientConformerEncoder

    @staticmethod
    def encoder_conf_for(conf: dict, streaming: bool) -> dict:
        conf = dict(conf)
        conf.update(conf.pop('efficient_conf', None) or {})
        if streaming:
            conf.update(use_dynamic_chunk=True, causal=True)
        return conf

    @property
    def output_factor(self) -> int:
        """The strides' product: the time reduction after the input layer
        (the predictor's chunk output length)."""
        f = 1
        if self.encoder.stride_idx:
            for s in self.encoder.strides:
                f *= s
        return f
