"""Transformer attention decoder (counterpart of
ppasr_tpu/models/transformer_decoder.py:25-169), for attention rescoring.

- ``DecoderLayer`` (:25-72): causal self-attention, cross-attention to the
  encoder output and a ReLU feed-forward, each with a pre- or post-
  LayerNorm (eps 1e-12) and a residual.
- ``TransformerDecoder`` (:75-126): token embedding ×sqrt(d) (the scale
  rounded to the compute dtype) plus the sinusoid table, the causal-and-pad
  mask, the layers, ``after_norm`` and ``output_layer``.
- ``BiTransformerDecoder`` (:129-169): a left-to-right decoder and, when
  ``r_num_blocks > 0``, a right-to-left one over reversed labels.

The layers are registered as ``layer_<i>``, the flax names, so the
checkpoint maps onto them leaf for leaf. Dropout as in the JAX modules
(:38-69, :105-107): on each residual branch, inside the feed-forward, on
both attentions' probabilities and after the positional stage, active in
``train()`` mode.
"""
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.models.attention import MultiHeadedAttention
from ppasr_tpu_torch.models.base import (Dropout, Embedding, LayerNorm,
                                         Linear, dtype_scalar)
from ppasr_tpu_torch.models.embedding import sinusoid_table
from ppasr_tpu_torch.models.positionwise import PositionwiseFeedForward
from ppasr_tpu_torch.ops.masks import make_non_pad_mask, subsequent_mask


class DecoderLayer(nn.Module):
    def __init__(self, size: int, attention_heads: int, linear_units: int,
                 normalize_before: bool = True, dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout = Dropout(dropout_rate)
        self.norm1 = LayerNorm(size, eps=1e-12)
        self.self_attn = MultiHeadedAttention(
            attention_heads, size, dropout_rate=self_attention_dropout_rate)
        self.norm2 = LayerNorm(size, eps=1e-12)
        self.src_attn = MultiHeadedAttention(
            attention_heads, size, dropout_rate=src_attention_dropout_rate)
        self.norm3 = LayerNorm(size, eps=1e-12)
        self.feed_forward = PositionwiseFeedForward(size, linear_units,
                                                    F.relu, dropout_rate)

    def _sublayer(self, x, norm, fn):
        y = fn(norm(x) if self.normalize_before else x)
        x = x + self.dropout(y)
        return x if self.normalize_before else norm(x)

    def forward(self, tgt, tgt_mask, memory, memory_mask):
        x = self._sublayer(tgt, self.norm1, lambda y: self.self_attn(
            y, y, y, mask=tgt_mask)[0])
        x = self._sublayer(x, self.norm2, lambda y: self.src_attn(
            y, memory, memory, mask=memory_mask)[0])
        return self._sublayer(x, self.norm3, self.feed_forward)


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, normalize_before: bool = True,
                 use_output_layer: bool = True, max_len: int = 5000,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0):
        super().__init__()
        d = encoder_output_size
        self.d_model = d
        self.normalize_before = normalize_before
        self.embed = Embedding(vocab_size, d)
        self.pos_dropout = Dropout(positional_dropout_rate)
        self.register_buffer('pe', torch.from_numpy(sinusoid_table(d,
                                                                   max_len)),
                             persistent=False)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f'layer_{i}', DecoderLayer(
                d, attention_heads, linear_units, normalize_before,
                dropout_rate, self_attention_dropout_rate,
                src_attention_dropout_rate))
        if normalize_before:
            self.after_norm = LayerNorm(d, eps=1e-12)
        self.output_layer = (Linear(d, vocab_size) if use_output_layer
                             else None)

    def forward(self, memory, memory_mask, ys_in_pad, ys_in_lens):
        """memory [B, T, D] encoder output, memory_mask [B, 1, T] bool,
        ys_in_pad [B, U+1] input ids (sos + labels), ys_in_lens [B] →
        logits [B, U+1, V] in the compute dtype."""
        u = ys_in_pad.shape[1]
        x = self.embed(ys_in_pad)
        x = x * dtype_scalar(self.d_model ** 0.5, x.dtype) \
            + self.pe[None, :u].to(x.dtype)
        x = self.pos_dropout(x)
        tgt_mask = make_non_pad_mask(ys_in_lens, u)[:, None, :] \
            & subsequent_mask(u, ys_in_pad.device)[None]
        memory = memory.to(x.dtype)
        for i in range(self.num_blocks):
            x = getattr(self, f'layer_{i}')(x, tgt_mask, memory, memory_mask)
        if self.normalize_before:
            x = self.after_norm(x)
        if self.output_layer is not None:
            x = self.output_layer(x)
        return x


class BiTransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, encoder_output_size: int,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 3, r_num_blocks: int = 3,
                 dropout_rate: float = 0.1,
                 positional_dropout_rate: float = 0.1,
                 self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0,
                 normalize_before: bool = True):
        super().__init__()
        common = dict(vocab_size=vocab_size,
                      encoder_output_size=encoder_output_size,
                      attention_heads=attention_heads,
                      linear_units=linear_units,
                      normalize_before=normalize_before,
                      dropout_rate=dropout_rate,
                      positional_dropout_rate=positional_dropout_rate,
                      self_attention_dropout_rate=self_attention_dropout_rate,
                      src_attention_dropout_rate=src_attention_dropout_rate)
        self.left_decoder = TransformerDecoder(num_blocks=num_blocks,
                                               **common)
        self.right_decoder = (TransformerDecoder(num_blocks=r_num_blocks,
                                                 **common)
                              if r_num_blocks > 0 else None)

    def forward(self, memory, memory_mask, ys_in_pad, ys_in_lens,
                r_ys_in_pad=None):
        """→ (L2R logits, R2L logits or None); the R2L pass runs when the
        decoder has one and ``r_ys_in_pad`` is given."""
        l_x = self.left_decoder(memory, memory_mask, ys_in_pad, ys_in_lens)
        r_x = None
        if self.right_decoder is not None and r_ys_in_pad is not None:
            r_x = self.right_decoder(memory, memory_mask, r_ys_in_pad,
                                     ys_in_lens)
        return l_x, r_x
