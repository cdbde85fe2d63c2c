"""Sinusoid positional table (copy of ppasr_tpu/models/embedding.py:19-27)
and its per-stream window for a streaming chunk (``chunk_positions``), which
every encoder's ``forward_chunk`` reads."""
import math

import numpy as np
import torch


def sinusoid_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """[max_len, d_model] interleaved sin/cos table."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def chunk_positions(pe: torch.Tensor, offsets: torch.Tensor, c: int,
                    s: int) -> torch.Tensor:
    """[B, S, D] positional rows for key slots 0..S-1 of each stream: rows
    offset−C+j of ``pe`` left-padded by C zero rows, the slice start
    clamped into the padded table as ``jax.lax.dynamic_slice`` clamps
    it."""
    start = offsets.to(torch.long).clamp(0, c + pe.shape[0] - s)
    idx = start[:, None] + torch.arange(s, device=offsets.device) - c
    rows = pe[idx.clamp(min=0)]
    return rows * (idx >= 0)[..., None].to(rows.dtype)
