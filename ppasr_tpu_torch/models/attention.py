"""Multi-head attention, absolute or Transformer-XL relative position
(counterpart of ppasr_tpu/models/attention.py:27-145).

Relative position: scores = ((q+u)·kᵀ + (q+v)·pᵀ) / sqrt(dk) with
pos_bias_u/v [H, dk] and no rel-shift (:117-128). The key/value cache is
passed in by the encoder as tensors of a fixed size and prepended along
time; masked entries are re-zeroed after the softmax, so fully masked rows
give zeros rather than NaN. Dropout on the attention probabilities
(:142). ``out_init_scale`` is the depth-scaled init of ``linear_out``.

The Squeezeformer's options (:33-50, :76-78): ``adaptive_scale`` applies
``ada_scale``·x + ``ada_bias`` to the query, key and value inputs;
``pos_bias`` gives ``linear_pos`` a bias; ``init_weights`` is its
scale-aware init, U(±n_feat^-0.5) for every projection, biases included.

Under tensor parallelism (``parallel/tensor_parallel.shard_module``) ``tp``
is the mesh and the module computes its rank's ``n_head`` heads: each
distinct input enters the model axis once, after the adaptive scale, the
projections are column shards and ``linear_out`` reduces.
"""
import math

import torch
from torch import nn

from ppasr_tpu_torch.models.base import Dropout, Linear
from ppasr_tpu_torch.parallel.tensor_parallel import copy_to_model


def attention_inputs(attn, query, key, value):
    """An attention's inputs after its adaptive scale (``ada_scale``, if
    it has one), in the model axis of its mesh ``tp``: one copy of each
    distinct tensor (one for self-attention)."""
    scale = getattr(attn, 'ada_scale', None)

    def enter(x):
        if scale is not None:
            x = scale.to(x.dtype) * x + attn.ada_bias.to(x.dtype)
        return copy_to_model(x, attn.tp)
    query_in = enter(query)
    key_in = query_in if key is query else enter(key)
    return query_in, key_in, key_in if value is key else enter(value)


class MultiHeadedAttention(nn.Module):
    tp = None

    def __init__(self, n_head: int, n_feat: int, rel_pos: bool = False,
                 dropout_rate: float = 0.0, out_init_scale: float = 1.0,
                 adaptive_scale: bool = False, pos_bias: bool = False,
                 init_weights: bool = False):
        super().__init__()
        if n_feat % n_head:
            raise ValueError(f"n_feat {n_feat} not divisible by {n_head} heads")
        self.n_head, self.n_feat = n_head, n_feat
        self.d_k = n_feat // n_head
        self.rel_pos = rel_pos
        bound = n_feat ** -0.5 if init_weights else None
        self.linear_q = Linear(n_feat, n_feat, init_bound=bound)
        self.linear_k = Linear(n_feat, n_feat, init_bound=bound)
        self.linear_v = Linear(n_feat, n_feat, init_bound=bound)
        self.linear_out = Linear(
            n_feat, n_feat, init_bound=bound,
            init_scale=1.0 if init_weights else out_init_scale)
        self.dropout = Dropout(dropout_rate)
        if rel_pos:
            self.linear_pos = Linear(n_feat, n_feat, bias=pos_bias,
                                     init_bound=bound)
            self.pos_bias_u = nn.Parameter(torch.zeros(n_head, self.d_k))
            self.pos_bias_v = nn.Parameter(torch.zeros(n_head, self.d_k))
        if adaptive_scale:
            self.ada_scale = nn.Parameter(torch.ones(1, 1, n_feat))
            self.ada_bias = nn.Parameter(torch.zeros(1, 1, n_feat))
        else:
            self.ada_scale = None

    def _heads(self, x, proj):
        b, t, _ = x.shape
        return proj(x).view(b, t, self.n_head, self.d_k)

    def forward(self, query, key, value, mask=None, pos_emb=None,
                kv_cache=None):
        """query/key/value [B, T1/T2, D]; mask [B, 1 or T1, S] bool, True =
        attend, S counting the cache; pos_emb [1 or B, S, D]; kv_cache
        (k, v) each [B, C, H, dk]. Returns (out [B, T1, D], (k_all, v_all)
        each [B, C+T2, H, dk])."""
        query, key, value = attention_inputs(self, query, key, value)
        q = self._heads(query, self.linear_q)
        k = self._heads(key, self.linear_k)
        v = self._heads(value, self.linear_v)
        if kv_cache is not None:
            k = torch.cat([kv_cache[0], k], dim=1)
            v = torch.cat([kv_cache[1], v], dim=1)

        if self.rel_pos:
            p = self.linear_pos(pos_emb).view(pos_emb.shape[0], -1,
                                              self.n_head, self.d_k)
            matrix_ac = torch.einsum('bthd,bshd->bhts',
                                     q + self.pos_bias_u.to(q.dtype), k)
            matrix_bd = torch.einsum('bthd,bshd->bhts',
                                     q + self.pos_bias_v.to(q.dtype),
                                     p.expand(q.shape[0], -1, -1, -1))
            scores = (matrix_ac + matrix_bd) / math.sqrt(self.d_k)
        else:
            scores = torch.einsum('bthd,bshd->bhts', q, k) / math.sqrt(self.d_k)

        if mask is not None:
            m = mask[:, None, :, :scores.shape[-1]]      # [B, 1, T1|1, S]
            neg = torch.finfo(scores.dtype).min / 2
            scores = scores.masked_fill(~m, neg)
            attn = torch.softmax(scores, dim=-1).masked_fill(~m, 0.0)
        else:
            attn = torch.softmax(scores, dim=-1)

        x = torch.einsum('bhts,bshd->bthd', self.dropout(attn), v)
        b, t1 = x.shape[0], x.shape[1]
        return self.linear_out(x.reshape(b, t1, self.n_feat)), (k, v)
