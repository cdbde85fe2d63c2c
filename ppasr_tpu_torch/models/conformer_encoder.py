"""Conformer encoder: full-context forward and streaming chunk forward
(counterpart of ppasr_tpu/models/conformer_encoder.py).

- ``ConformerEncoderLayer`` (:57-172): macaron FFN ×0.5 → MHSA → conv module
  → FFN ×0.5 → optional block-final LayerNorm; pre- or post-LN.
- ``ConformerEncoder.forward`` (:264-300): CMVN → Conv2dSubsampling4 →
  positional table (rel-pos: no ×sqrt(d) scale, :230-245) → chunk/pad mask
  → blocks → after_norm.
- ``forward_chunk`` (:317-371) with the static ring caches of
  ``StreamingState`` (:45-54): the attention cache holds the last C keys and
  values of every layer, right-aligned, with ``cache_len`` of them valid;
  the positional rows of key slot j are those of position offset − C + j,
  read from the table left-padded by C zero rows.

Compute dtype (``models/base.cast_for_compute``): the features enter in
float32, go through the CMVN in float32 and are cast to the weights' dtype
at the subsampling input, where the JAX model's first cast is (its
``GlobalCMVN`` computes in the input's dtype, its ``Conv`` casts). The
positional table is cast with the weights (:237-238), the ×sqrt(d) scale
is rounded to the dtype (:251), and the streaming caches are zeroed in the
dtype (:302-315).

Training (``module.train()``): dropout on every residual branch, inside the
feed-forwards, on the attention probabilities and after the positional
stage (:83-172, :273); and the dynamic-chunk mask drawn once per batch
(:275-284), from ``chunk_generator``. In eval
mode a dynamic-chunk encoder with ``decoding_chunk_size`` 0 uses the full
context (:283-289). ``depth_scaled_init`` sets the init scale
(2·num_blocks)^-1/2 of each residual branch's output projection
(``models/base.init_parameters``); ``remat`` is accepted for config
compatibility and has no effect.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ppasr_tpu_torch.models.attention import MultiHeadedAttention
from ppasr_tpu_torch.models.base import (Dropout, GlobalCMVN, LayerNorm,
                                         compute_dtype_of, dtype_scalar,
                                         get_activation, swish)
from ppasr_tpu_torch.models.convolution import ConvolutionModule
from ppasr_tpu_torch.models.embedding import chunk_positions, sinusoid_table
from ppasr_tpu_torch.models.positionwise import PositionwiseFeedForward
from ppasr_tpu_torch.models.subsampling import subsampling_class
from ppasr_tpu_torch.ops.masks import add_optional_chunk_mask, make_non_pad_mask


class StreamingState(NamedTuple):
    """Per-stream encoder state, kept on the model's device."""
    offset: torch.Tensor     # [B] int32: encoder frames consumed so far
    cache_len: torch.Tensor  # [B] int32: valid frames in the attention cache
    att_k: torch.Tensor      # [L, B, C, H, dk]
    att_v: torch.Tensor      # [L, B, C, H, dk]
    cnn_cache: torch.Tensor  # [L, B, lorder, D]

    def stream_axes(self):
        return StreamingState(0, 0, 1, 1, 1)


class ConformerEncoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 normalize_before: bool = True, macaron_style: bool = True,
                 use_cnn_module: bool = True, cnn_module_kernel: int = 15,
                 cnn_module_norm: str = 'layer_norm', causal: bool = False,
                 activation=swish, rel_pos: bool = True,
                 final_norm: bool = True, dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 out_init_scale: float = 1.0):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.normalize_before = normalize_before
        self.macaron_style = macaron_style
        self.use_cnn_module = use_cnn_module
        self.final_norm = final_norm and use_cnn_module
        ln = lambda: LayerNorm(size, eps=1e-5)  # noqa: E731
        if macaron_style:
            self.norm_ff_macaron = ln()
            self.feed_forward_macaron = PositionwiseFeedForward(
                size, linear_units, activation, dropout_rate, out_init_scale)
        self.norm_mha = ln()
        self.self_attn = MultiHeadedAttention(
            attention_heads, size, rel_pos, attention_dropout_rate,
            out_init_scale)
        if use_cnn_module:
            self.norm_conv = ln()
            self.conv_module = ConvolutionModule(
                size, cnn_module_kernel, activation, cnn_module_norm, causal,
                out_init_scale)
        self.norm_ff = ln()
        self.feed_forward = PositionwiseFeedForward(
            size, linear_units, activation, dropout_rate, out_init_scale)
        if self.final_norm:
            self.norm_final = ln()

    def _sublayer(self, x, norm, fn, scale=1.0):
        """Residual around ``fn`` with pre- or post-LayerNorm and dropout;
        ``fn`` returns (y, extra)."""
        y, extra = fn(norm(x) if self.normalize_before else x)
        x = x + scale * self.dropout(y)
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
        new_cnn_cache = None
        if self.use_cnn_module:
            x, new_cnn_cache = self._sublayer(
                x, self.norm_conv,
                lambda y: self.conv_module(y, mask_pad, cnn_cache))
        x, _ = self._sublayer(x, self.norm_ff,
                              lambda y: (self.feed_forward(y), None), ff_scale)
        if self.final_norm:
            x = self.norm_final(x)
        return x, new_kv, new_cnn_cache


class ConformerEncoder(nn.Module):
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
                 max_len: int = 5000, cmvn_mean: Optional[tuple] = None,
                 cmvn_istd: Optional[tuple] = None,
                 depth_scaled_init: bool = True,
                 block_final_norm: bool = True, remat: bool = False):
        super().__init__()
        if pos_enc_layer_type not in ('rel_pos', 'abs_pos', 'no_pos'):
            raise ValueError(f"unknown pos_enc_layer_type {pos_enc_layer_type}")
        self.output_size = output_size
        self.attention_heads = attention_heads
        self.num_blocks = num_blocks
        self.pos_enc_layer_type = pos_enc_layer_type
        self.normalize_before = normalize_before
        self.static_chunk_size = static_chunk_size
        self.use_dynamic_chunk = use_dynamic_chunk
        self.use_dynamic_left_chunk = use_dynamic_left_chunk
        self.max_len = max_len
        self.lorder = cnn_module_kernel - 1 if causal else 0
        self.global_cmvn = (GlobalCMVN(cmvn_mean, cmvn_istd)
                            if cmvn_mean is not None else None)
        sub = subsampling_class(input_layer)
        self.subsampling_rate = sub.subsampling_rate
        self.right_context = sub.right_context
        self.out_len = sub.out_len
        self.embed = sub(input_size, output_size)
        self.pos_dropout = Dropout(positional_dropout_rate)
        activation = get_activation(activation_type)
        out_init_scale = (2.0 * num_blocks) ** -0.5 if depth_scaled_init \
            else 1.0
        self.layers = nn.ModuleList([ConformerEncoderLayer(
            output_size, attention_heads, linear_units, normalize_before,
            macaron_style, use_cnn_module, cnn_module_kernel, cnn_module_norm,
            causal, activation, pos_enc_layer_type == 'rel_pos',
            block_final_norm, dropout_rate, attention_dropout_rate,
            out_init_scale) for _ in range(num_blocks)])
        if normalize_before:
            self.after_norm = LayerNorm(output_size, eps=1e-5)
        self.register_buffer(
            'pe', torch.from_numpy(sinusoid_table(output_size, max_len)),
            persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (``models/base.compute_dtype_of``)."""
        return compute_dtype_of(self.embed.Dense_0)

    def _embed(self, xs):
        if self.global_cmvn is not None:
            xs = self.global_cmvn(xs)
        return self.embed(xs.to(self.dtype))

    def _apply_pos(self, xs, pos_emb):
        if self.pos_enc_layer_type == 'no_pos':
            return xs, None
        if self.pos_enc_layer_type == 'abs_pos':
            xs = xs * dtype_scalar(np.sqrt(self.output_size), xs.dtype)
            xs = xs + pos_emb[:, -xs.shape[1]:]
        return xs, pos_emb       # rel_pos: no ×sqrt(d) (JAX :230-245)

    def forward(self, xs, xs_lens, decoding_chunk_size: int = 0,
                num_decoding_left_chunks: int = -1, chunk_generator=None):
        """Full-utterance forward. xs [B, T, D] padded features, xs_lens [B].
        Returns (out [B, T', D'], masks [B, 1, T'] bool). In train mode a
        dynamic-chunk encoder with ``decoding_chunk_size`` 0 draws its chunk
        (``ops/masks.add_optional_chunk_mask``)."""
        xs = self._embed(xs)
        t_sub = xs.shape[1]
        out_lens = self.out_len(xs_lens.to(torch.long))
        masks = make_non_pad_mask(out_lens, t_sub)[:, None, :]
        xs, pos_emb = self._apply_pos(xs, self.pe[None, :t_sub].to(xs.dtype))
        xs = self.pos_dropout(xs)
        dcs = decoding_chunk_size
        if self.use_dynamic_chunk and dcs == 0 and not self.training:
            dcs = -1      # deterministic eval on a dynamic-chunk model
        chunk_masks = add_optional_chunk_mask(
            t_sub, masks, self.use_dynamic_chunk, self.use_dynamic_left_chunk,
            dcs, self.static_chunk_size, num_decoding_left_chunks,
            generator=chunk_generator)
        for layer in self.layers:
            xs, _, _ = layer(xs, chunk_masks, pos_emb, masks)
        if self.normalize_before:
            xs = self.after_norm(xs)
        return xs, masks

    def init_state(self, batch_size: int, cache_size: int,
                   device=None) -> StreamingState:
        """Zero streaming state with static attention cache size C."""
        h, dk = self.attention_heads, self.output_size // self.attention_heads
        device = device if device is not None else self.pe.device
        z = lambda *s: torch.zeros(s, device=device,  # noqa: E731
                                   dtype=self.dtype)
        return StreamingState(
            offset=torch.zeros(batch_size, dtype=torch.int32, device=device),
            cache_len=torch.zeros(batch_size, dtype=torch.int32,
                                  device=device),
            att_k=z(self.num_blocks, batch_size, cache_size, h, dk),
            att_v=z(self.num_blocks, batch_size, cache_size, h, dk),
            cnn_cache=z(self.num_blocks, batch_size, self.lorder,
                        self.output_size))

    def forward_chunk(self, xs, state: StreamingState):
        """One streaming chunk. xs [B, T_in, D] with
        T_in = (chunk−1)·subsampling + right_context + 1.
        Returns (out [B, T_out, D'], new_state)."""
        c = state.att_k.shape[2]
        xs = self._embed(xs)
        b, t_out = xs.shape[0], xs.shape[1]
        s = c + t_out
        offsets = state.offset.reshape(-1).expand(b)
        xs, pos_emb = self._apply_pos(
            xs, chunk_positions(self.pe.to(self.dtype), offsets, c, s))

        # key slot j is valid iff j ≥ C − cache_len (cache right-aligned) or
        # it is in the current chunk
        cache_len = state.cache_len.reshape(-1).expand(b)
        j = torch.arange(s, device=xs.device)[None, None, :]
        att_mask = j >= (c - cache_len.to(torch.long))[:, None, None]

        new_k, new_v, new_cnn = [], [], []
        for i, layer in enumerate(self.layers):
            cnn_cache = state.cnn_cache[i] if self.lorder else None
            xs, (k_all, v_all), cnn_c = layer(
                xs, att_mask, pos_emb, kv_cache=(state.att_k[i],
                                                 state.att_v[i]),
                cnn_cache=cnn_cache)
            new_k.append(k_all[:, k_all.shape[1] - c:])
            new_v.append(v_all[:, v_all.shape[1] - c:])
            new_cnn.append(cnn_c if cnn_c is not None
                           else xs.new_zeros(b, 0, self.output_size))
        if self.normalize_before:
            xs = self.after_norm(xs)
        new_state = StreamingState(
            offset=state.offset + t_out,
            cache_len=torch.clamp(state.cache_len + t_out, max=c),
            att_k=torch.stack(new_k), att_v=torch.stack(new_v),
            cnn_cache=torch.stack(new_cnn))
        return xs, new_state
