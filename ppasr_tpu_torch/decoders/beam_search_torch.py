"""Vectorised CTC prefix beam search on the device, with n-gram shallow
fusion (counterpart of ppasr_tpu/decoders/beam_search_jax.py; this is the
predictor's default ``backend``, named ``'torch'`` or, as in configs written
for the JAX package, ``'jax'``).

The search runs on the decoder's ``device`` with the batch and beam axes
vectorised: a batch decode reads the host once (the compacted length), and
the streaming state (prefixes, beam scores) stays on the device between
chunks.

Two phases, as in the JAX package:
  Phase 1 — candidates, one batched pass over [B, T, V]: per-frame blank
    log-prob and the top-N tokens with the cumulative cutoff mask; with
    blank-frame compaction the kept frames are found from the blank column
    first, the compacted length is read on the host and rounded up to a
    64-frame bucket, and only the kept rows go through the top-N.
  Phase 2 — the beam loop over frames (beam K, candidates N): K "stay"
    entries and K·N "extend" entries; prefixes identified by a 32-bit
    rolling hash and merged by ``'match'`` (a [K·N, K] stay↔extend hash
    compare and a masked logsumexp, the default), ``'sort'`` (a stable sort
    by hash and a neighbour pair-merge) or the experimental scatter mode
    (``scatter_reduce`` over hash buckets); the top K by total probability
    re-form the beam.

Differences from the JAX package, each kept to the same results:
  - ``BeamState`` fields carry a leading [B] axis; there is no vmap.
  - 32-bit hashes live in int64 tensors holding values in [0, 2^32): each
    multiply is split into 16-bit halves so no int64 product overflows, and
    each sum is masked with ``& 0xFFFFFFFF``; shifts of non-negative values
    are logical. The sentinels 0xFFFFFFFF (dead entry) and 0xFFFFFFFE (dead
    extend) are exact.
  - Top-k is a stable descending sort, so among equal values the lower index
    comes first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises
    no order). ``prune_method='approx'`` is the same exact top-k, as
    ``lax.approx_max_k`` is off the TPU.
  - Compaction is a gather through the permutation that puts the kept frames
    first, not a scatter with repeated indices; every slot the JAX scatter
    writes gets the same value, the last one the last dropped frame.
  - The loop is a Python loop over frames with ``active = t < lens`` as a
    tensor (no host read per step). After compaction it runs the compacted
    length's steps, not the bucket's: the steps past it are inactive for
    every row.
  - Everything is float32 on the CUDA cores; no step uses TF32.
"""
import hashlib
import math
import os
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from ppasr_tpu_torch.decoders.lm import NgramScorer, build_hash_tables
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)

NEG_INF = -1e30
HASH_PRIME = 1000003
MASK32 = 0xFFFFFFFF
DEAD_HASH = 0xFFFFFFFF       # a dead pool entry: never merges with a live one
DEAD_EXT_HASH = 0xFFFFFFFE   # a dead extend in the match merge
_H1_SEED, _H1_MULT = 2166136261, 0x9E3779B1   # lm._fold_hash's constants
_H2_SEED, _H2_MULT = 0x27220A95, 0x85EBCA6B


class BeamState(NamedTuple):
    """Device-resident beam state of a batch (leading axes [B, K])."""
    prefixes: torch.Tensor   # [B, K, U_max] int32
    lengths: torch.Tensor    # [B, K] int64
    last: torch.Tensor       # [B, K] int64, -1 = empty prefix
    hashes: torch.Tensor     # [B, K] int64 holding uint32 values
    p_b: torch.Tensor        # [B, K] f32 log prob ending in blank
    p_nb: torch.Tensor       # [B, K] f32 log prob ending in non-blank


def init_beam_state(beam_size: int, max_len: int, batch_size: int = 1,
                    device='cpu') -> BeamState:
    k, b = beam_size, batch_size
    p_b = torch.full((b, k), NEG_INF, dtype=torch.float32, device=device)
    p_b[:, 0] = 0.0
    return BeamState(
        prefixes=torch.zeros((b, k, max_len), dtype=torch.int32,
                             device=device),
        lengths=torch.zeros((b, k), dtype=torch.int64, device=device),
        last=torch.full((b, k), -1, dtype=torch.int64, device=device),
        hashes=torch.zeros((b, k), dtype=torch.int64, device=device),
        p_b=p_b,
        p_nb=torch.full((b, k), NEG_INF, dtype=torch.float32, device=device))


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


# ------------------------------------------------------- hash-table LM

class HashLM:
    """Device-resident n-gram LM for orders >= 3 (see lm.build_hash_tables).

    ``ds``/``fps``/``logps``/``backoffs`` are per-order tuples (n =
    2..order) of CHD perfect-hash tables: ``ds`` holds the per-bucket
    displacements, so a lookup inspects exactly one slot. Displacements and
    fingerprints are int64 tensors holding uint32 values."""

    def __init__(self, uni_logp, uni_found, uni_backoff, ds, fps, logps,
                 backoffs):
        self.uni_logp = uni_logp        # [V] f32 log10 (-6.0 when absent)
        self.uni_found = uni_found      # [V] bool
        self.uni_backoff = uni_backoff  # [V] f32 log10
        self.ds = tuple(ds)             # n=2..order: [B_n]
        self.fps = tuple(fps)           # n=2..order: [M_n], 0 = empty
        self.logps = tuple(logps)       # f32 [M_n]
        self.backoffs = tuple(backoffs)  # f32 [M_n]

    @property
    def order(self) -> int:
        return len(self.fps) + 1

    def tensors(self):
        return [self.uni_logp, self.uni_found, self.uni_backoff, *self.ds,
                *self.fps, *self.logps, *self.backoffs]


def hash_lm_from_tables(t, device='cpu') -> HashLM:
    """lm.build_hash_tables output dict → HashLM on ``device``."""
    def i64(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return HashLM(
        uni_logp=f32(t['uni_logp']),
        uni_found=torch.from_numpy(np.asarray(t['uni_found'], bool)).to(
            device),
        uni_backoff=f32(t['uni_backoff']),
        ds=tuple(i64(d) for (d, _, _, _) in t['tables']),
        fps=tuple(i64(fp) for (_, fp, _, _) in t['tables']),
        logps=tuple(f32(lp) for (_, _, lp, _) in t['tables']),
        backoffs=tuple(f32(bk) for (_, _, _, bk) in t['tables']))


def _mul32(h, c: int):
    """(h · c) mod 2^32 for int64 ``h`` in [0, 2^32) and a constant
    ``c`` < 2^32. The 16-bit halves of ``h`` are multiplied apart, so no
    product leaves int64."""
    return ((h & 0xFFFF) * c + (((h >> 16) * c) & 0xFFFF) * 65536) & MASK32


def _fmix32_dev(h):
    """Murmur3 avalanche, matching lm._fmix32 bit for bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _hash_fold(tokens):
    """Rolling 32-bit hashes over token tensors (oldest → newest), matching
    lm._fold_hash bit for bit. ``tokens``: broadcast-compatible integer
    tensors, -1 = no token; returns (slot hash, fingerprint hash)."""
    h1 = h2 = None
    for t in tokens:
        tt = (t.to(torch.int64) + 1) & MASK32
        if h1 is None:
            h1 = ((_H1_SEED * _H1_MULT) & MASK32) + tt & MASK32
            h2 = ((_H2_SEED * _H2_MULT) & MASK32) + tt & MASK32
        else:
            h1 = _mul32(h1, _H1_MULT) + tt & MASK32
            h2 = _mul32(h2, _H2_MULT) + tt & MASK32
    return _fmix32_dev(h1), _fmix32_dev(h2)


def _hash_lookup(d_table, fp_table, val_table, h1, h2):
    """CHD perfect-hash lookup: the bucket's displacement, then exactly one
    slot. Returns (found bool, value); the value means something only where
    found."""
    d = d_table[h1 & (d_table.shape[0] - 1)]
    slot = _fmix32_dev(h2 ^ d) & (fp_table.shape[0] - 1)
    found = fp_table[slot] == (h2 | 1)
    return found, val_table[slot]


def _hash_lm_score(lm: HashLM, ctx, cand):
    """log10 P(cand | ctx) with the full backoff chain, on the device.

    ctx: [..., K, order-1] context token ids, NEWEST FIRST (ctx[..., 0] is
    the last emitted char), -1 = no token. cand: [..., N]. Returns
    [..., K, N].

    Mirrors NgramScorer._score_tokens: the longest matched n-gram's log-prob
    plus the backoff weights of every longer context in the LM, bottom-up as
        f_n = found_n ? logp_n : bo(ctx_{n-1}) + f_{n-1}
    (bo = 0 when the context itself is absent). Tokens absent from the LM
    score a flat -6.0 with no backoff sum."""
    k = ctx.shape[-2]
    f = lm.uni_logp[cand].unsqueeze(-2).expand(
        *cand.shape[:-1], k, cand.shape[-1])                 # [..., K, N]
    for n in range(2, lm.order + 1):
        toks = [ctx[..., j] for j in range(n - 2, -1, -1)]  # oldest → newest
        valid = ctx[..., n - 2] >= 0  # newest-first ⇒ oldest present = all
        h1, h2 = _hash_fold([t.unsqueeze(-1) for t in toks]
                            + [cand.unsqueeze(-2)])
        found, logp = _hash_lookup(lm.ds[n - 2], lm.fps[n - 2],
                                   lm.logps[n - 2], h1, h2)  # [..., K, N]
        if n == 2:
            last = torch.where(valid, ctx[..., 0], 0)
            bo = torch.where(valid & lm.uni_found[last],
                             lm.uni_backoff[last], 0.0)      # [..., K]
        else:
            bh1, bh2 = _hash_fold(toks)                      # [..., K]
            bfound, bval = _hash_lookup(lm.ds[n - 3], lm.fps[n - 3],
                                        lm.backoffs[n - 3], bh1, bh2)
            bo = torch.where(valid & bfound, bval, 0.0)
        found = found & valid.unsqueeze(-1)
        f = torch.where(found, logp, bo.unsqueeze(-1) + f)
    return torch.where(lm.uni_found[cand].unsqueeze(-2), f, -6.0)


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    live = m > NEG_INF / 2
    safe = torch.where(live, m, 0.0)
    out = safe + torch.log(torch.exp(a - safe) + torch.exp(b - safe))
    return torch.where(live, out, NEG_INF)


def _top_k(x, k: int):
    """The k largest along the last axis, lower index first among equal
    values (jax.lax.top_k's order): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# --------------------------------------------------------------- phase 1

def precompute_candidates(probs, blank, top_n, cutoff_prob,
                          prune_method: str = 'exact'):
    """[..., V] probs → (lp_blank [...], cand [..., N] int64,
    cand_lp [..., N]). The only pass that reads the vocab axis.
    ``prune_method`` 'approx' is the same exact top-k."""
    v = probs.shape[-1]
    lp_blank = torch.log(torch.clamp_min(probs[..., blank], 1e-30))
    no_blank = torch.where(torch.arange(v, device=probs.device) == blank,
                           0.0, probs)
    cand_p, cand = _top_k(no_blank, top_n)
    keep = torch.cumsum(cand_p, dim=-1) - cand_p < cutoff_prob
    cand_lp = torch.where(keep, torch.log(torch.clamp_min(cand_p, 1e-30)),
                          NEG_INF)
    return lp_blank, cand, cand_lp


def candidates_from_logits(logits, lse, blank, top_n, cutoff_prob,
                           prune_method: str = 'exact'):
    """[..., V] logits + their f32 logsumexp [...] → (cand [..., N] int64,
    cand_lp [..., N] f32), equal to precompute_candidates on
    softmax(logits) without making the [..., V] posterior: top-k commutes
    with the monotone softmax, cand_lp = logit − logsumexp, floored at
    log(1e-30) as the probs path floors p at 1e-30."""
    v = logits.shape[-1]
    no_blank = torch.where(torch.arange(v, device=logits.device) == blank,
                           NEG_INF, logits)
    cand_v, cand = _top_k(no_blank, top_n)
    raw_lp = cand_v.float() - lse.unsqueeze(-1)
    cand_p = torch.exp(raw_lp)  # exp(-inf) = 0 for the blank slot
    keep = torch.cumsum(cand_p, dim=-1) - cand_p < cutoff_prob
    cand_lp = torch.clamp_min(raw_lp, math.log(1e-30))
    cand_lp = torch.where(keep, cand_lp, NEG_INF)
    return cand, cand_lp


def _pack_map(keep):
    """Left-packing of the kept frames of [B, T] ``keep``: ``src`` [B, T],
    the permutation that lists the kept frames, then the dropped ones, each
    in order, and ``written`` [B, T], the slots that the JAX package's
    scatter writes (the first n_kept, and slot T − 1, where the dropped
    frames pile up). ``src`` at slot T − 1 is the last dropped frame, the
    scatter's last write, when any frame is dropped."""
    t_max = keep.shape[1]
    n_kept = keep.sum(dim=1, keepdim=True)
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1,
                      n_kept + torch.cumsum(~keep, dim=1) - 1)
    t_iota = torch.arange(t_max, device=keep.device).expand_as(pos)
    src = torch.empty_like(pos).scatter_(1, pos, t_iota)  # pos: permutation
    written = (t_iota < n_kept) | (t_iota == t_max - 1)
    return src, written


def _gather_frames(x, src):
    """x [B, T, ...] gathered along T by src [B, T']."""
    idx = src.reshape(*src.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(*src.shape, *x.shape[2:]))


def compact_candidate_frames(lp_blank, cand, cand_lp, lens,
                             blank_skip_threshold: float):
    """Drop frames dominated by blank, in candidate space.

    A frame with P(blank) ≥ threshold multiplies every beam's mass by about
    P(blank), a shared constant that cannot change the ranking, so decoding
    only the other frames preserves the ranking. Kept frames are
    left-packed; returns (lp_blank, cand, cand_lp, new_lens)."""
    t_max = lp_blank.shape[1]
    keep = (torch.exp(lp_blank) < blank_skip_threshold) \
        & (torch.arange(t_max, device=lens.device)[None, :] < lens[:, None])
    src, written = _pack_map(keep)
    w3 = written.unsqueeze(-1)
    out_blank = torch.where(written, _gather_frames(lp_blank, src), 0.0)
    out_cand = torch.where(w3, _gather_frames(cand, src), 0)
    out_lp = torch.where(w3, _gather_frames(cand_lp, src), NEG_INF)
    new_lens = torch.clamp_min(keep.sum(dim=1), 1)
    return out_blank, out_cand, out_lp, new_lens


def compact_blank_frames(probs, lens, blank: int = 0,
                         blank_skip_threshold: float = 0.98):
    """Full-posterior compaction (the JAX package keeps it for API
    compatibility; the decode path compacts in candidate space)."""
    t_max = probs.shape[1]
    keep = (probs[:, :, blank] < blank_skip_threshold) \
        & (torch.arange(t_max, device=lens.device)[None, :] < lens[:, None])
    src, written = _pack_map(keep)
    out = torch.where(written.unsqueeze(-1), _gather_frames(probs, src), 0.0)
    return out, torch.clamp_min(keep.sum(dim=1), 1)


# --------------------------------------------------------------- phase 2

def _segment_reduce(vals, seg_id, num_segments, reduce):
    """Per-row segment reduction of [B, M] ``vals`` into [B, num_segments];
    empty segments hold the reduction's identity, as jax.ops.segment_*."""
    fill = {'amax': -math.inf, 'amin': math.inf, 'sum': 0}[reduce]
    if vals.dtype != torch.float32:
        fill = {'amax': torch.iinfo(vals.dtype).min,
                'amin': torch.iinfo(vals.dtype).max, 'sum': 0}[reduce]
    out = torch.full((vals.shape[0], num_segments), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce(1, seg_id, vals, reduce=reduce,
                              include_self=reduce == 'sum')


def _beam_step(state: BeamState, lp_blank, cand, cand_lp, top_n, beam_size,
               lm_bigram, lm_unigram, alpha, beta, merge_mode='match',
               lm_hash: Optional[HashLM] = None) -> BeamState:
    """One time step for a batch, over precomputed candidates.
    lp_blank: [B]; cand/cand_lp: [B, N]."""
    k = beam_size
    bsz, _, u_max = state.prefixes.shape
    dev = state.p_b.device

    p_tot = _logaddexp(state.p_b, state.p_nb)             # [B, K]

    # --- LM bonus for extending with candidate c given the prefix
    ln10 = math.log(10.0)
    if lm_hash is not None:
        # context = last (order-1) prefix tokens, newest first
        j = torch.arange(lm_hash.order - 1, device=dev)
        pos = state.lengths.unsqueeze(-1) - 1 - j          # [B, K, order-1]
        ctx = torch.where(pos >= 0, torch.gather(
            state.prefixes, 2, pos.clamp(0, u_max - 1)).to(torch.int64), -1)
        lm = _hash_lm_score(lm_hash, ctx, cand)            # [B, K, N]
        bonus = alpha * lm * ln10 + beta * ln10
    elif lm_bigram is not None or lm_unigram is not None:
        if lm_bigram is not None:
            ctx = torch.where(state.last < 0, 0, state.last)
            big = lm_bigram[ctx.unsqueeze(-1), cand.unsqueeze(-2)]  # [B,K,N]
            uni = lm_unigram[cand].unsqueeze(-2)
            lm = torch.where((state.last < 0).unsqueeze(-1), uni, big)
        else:
            lm = lm_unigram[cand].unsqueeze(-2)
        bonus = alpha * lm * ln10 + beta * ln10            # [B, K|1, N]
    else:
        bonus = torch.zeros((bsz, k, top_n), dtype=torch.float32, device=dev)

    # --- stay candidates: same prefix
    # blank path always; repeat path only when last is a valid candidate
    is_repeat = cand.unsqueeze(-2) == state.last.unsqueeze(-1)  # [B, K, N]
    lp_last = torch.where(
        state.last >= 0,
        torch.where(is_repeat, cand_lp.unsqueeze(-2), NEG_INF).amax(dim=-1),
        NEG_INF)                                           # [B, K]
    stay_p_b = p_tot + lp_blank.unsqueeze(-1)
    stay_p_nb = state.p_nb + lp_last

    # --- extend candidates: prefix + c for each candidate
    src = torch.where(is_repeat, state.p_b.unsqueeze(-1),
                      p_tot.unsqueeze(-1))
    ext_p_nb = src + cand_lp.unsqueeze(-2) + bonus         # [B, K, N]
    ext_hash = _mul32(state.hashes.unsqueeze(-1), HASH_PRIME) \
        + (cand.unsqueeze(-2) + 1) & MASK32                # [B, K, N]

    # --- pool: K stay + K*N extend
    pool_hash = torch.cat([state.hashes, ext_hash.reshape(bsz, -1)], dim=1)
    pool_p_b = torch.cat([stay_p_b, torch.full((bsz, k * top_n), NEG_INF,
                                               device=dev)], dim=1)
    pool_p_nb = torch.cat([stay_p_nb, ext_p_nb.reshape(bsz, -1)], dim=1)
    # provenance for gathering prefix storage after top-K
    beams = torch.arange(k, device=dev)
    pool_src_beam = torch.cat([beams, beams.repeat_interleave(top_n)])
    pool_ext_char = torch.cat([
        torch.full((bsz, k), -1, dtype=torch.int64, device=dev),
        cand.repeat(1, k)], dim=1)
    # dead-beam / pruned-candidate guard
    beam_alive = p_tot > NEG_INF / 2
    ext_alive = (beam_alive.unsqueeze(-1)
                 & (cand_lp > NEG_INF / 2).unsqueeze(-2)).reshape(bsz, -1)
    alive = torch.cat([beam_alive, ext_alive], dim=1)
    pool_p_b = torch.where(alive, pool_p_b, NEG_INF)
    pool_p_nb = torch.where(alive, pool_p_nb, NEG_INF)
    # kill hash so dead entries can't merge with real ones
    pool_hash = torch.where(alive, pool_hash, DEAD_HASH)

    m = pool_hash.shape[1]
    order = None
    if merge_mode == 'match':
        # a duplicate can only pair a STAY entry with an EXTEND entry (stay
        # prefixes are pairwise distinct, and so are extend prefixes): for
        # each extend, find the stay with an equal hash, fold its mass into
        # that stay and kill the extend
        stay_hash = torch.where(beam_alive, state.hashes, DEAD_HASH)
        ext_hash_flat = torch.where(ext_alive, ext_hash.reshape(bsz, -1),
                                    DEAD_EXT_HASH)
        hit = ext_hash_flat.unsqueeze(-1) == stay_hash.unsqueeze(-2)
        ext_vals = pool_p_nb[:, k:]                        # [B, K·N]
        fold_max = torch.where(hit, ext_vals.unsqueeze(-1),
                               NEG_INF).amax(dim=1)        # [B, K]
        safe = torch.where(fold_max > NEG_INF / 2, fold_max, 0.0)
        fold_sum = torch.where(
            hit, torch.exp(ext_vals.unsqueeze(-1) - safe.unsqueeze(-2)),
            0.0).sum(dim=1)
        folded = torch.where(
            fold_max > NEG_INF / 2,
            safe + torch.log(torch.clamp_min(fold_sum, 1e-38)), NEG_INF)
        merged_p_b = pool_p_b  # extends carry NEG_INF p_b already
        merged_p_nb = torch.cat([
            _logaddexp(pool_p_nb[:, :k], folded),
            torch.where(hit.any(dim=2), NEG_INF, ext_vals)], dim=1)
    elif merge_mode == 'sort':
        # sort by hash (stable, as jnp.argsort), then merge each entry with
        # its neighbour: a prefix appears in the pool at most twice
        order = torch.sort(pool_hash, dim=1, stable=True).indices
        s_hash = torch.gather(pool_hash, 1, order)
        s_p_b = torch.gather(pool_p_b, 1, order)
        s_p_nb = torch.gather(pool_p_nb, 1, order)
        same = s_hash[:, 1:] == s_hash[:, :-1]
        first = torch.cat([torch.ones((bsz, 1), dtype=torch.bool,
                                      device=dev), ~same], dim=1)
        next_same = torch.cat([same, torch.zeros((bsz, 1), dtype=torch.bool,
                                                 device=dev)], dim=1)

        def pair_merge(vals):
            nxt = torch.cat([vals[:, 1:], torch.full((bsz, 1), NEG_INF,
                                                     device=dev)], dim=1)
            merged = torch.where(next_same, _logaddexp(vals, nxt), vals)
            return torch.where(first, merged, NEG_INF)

        merged_p_b = pair_merge(s_p_b)
        merged_p_nb = pair_merge(s_p_nb)
    else:
        # EXPERIMENTAL scatter merge: bucket by hash mod H; lossy at
        # practical H (spurious merges), kept for experiments
        num_segments = _next_pow2(8 * m)
        seg_id = pool_hash % num_segments
        # representative = entry with max total in its bucket
        tot = _logaddexp(pool_p_b, pool_p_nb)
        bucket_max = _segment_reduce(tot, seg_id, num_segments, 'amax')
        first = tot >= torch.gather(bucket_max, 1, seg_id) - 1e-6
        # break ties (identical totals) by keeping the lowest index
        idxs = torch.arange(m, device=dev).expand(bsz, m)
        bucket_argmin = _segment_reduce(torch.where(first, idxs, m), seg_id,
                                        num_segments, 'amin')
        first = idxs == torch.gather(bucket_argmin, 1, seg_id)

        def seg_logsumexp(vals):
            seg_max = _segment_reduce(vals, seg_id, num_segments, 'amax')
            seg_max_safe = torch.where(seg_max > NEG_INF / 2, seg_max, 0.0)
            sums = _segment_reduce(
                torch.exp(vals - torch.gather(seg_max_safe, 1, seg_id)),
                seg_id, num_segments, 'sum')
            out = seg_max_safe + torch.log(torch.clamp_min(sums, 1e-38))
            return torch.gather(torch.where(sums > 0, out, NEG_INF), 1,
                                seg_id)

        merged_p_b = torch.where(first, seg_logsumexp(pool_p_b), NEG_INF)
        merged_p_nb = torch.where(first, seg_logsumexp(pool_p_nb), NEG_INF)

    merged_tot = _logaddexp(merged_p_b, merged_p_nb)
    top_vals, top_idx = _top_k(merged_tot, k)
    sel = torch.gather(order, 1, top_idx) if order is not None else top_idx

    sel_src = pool_src_beam[sel]                           # [B, K]
    sel_char = torch.gather(pool_ext_char, 1, sel)
    sel_is_ext = sel_char >= 0

    new_prefixes = torch.gather(
        state.prefixes, 1, sel_src.unsqueeze(-1).expand(-1, -1, u_max))
    src_lengths = torch.gather(state.lengths, 1, sel_src)
    ins_pos = src_lengths.clamp(0, u_max - 1)
    # masked one-hot write of the new token (the JAX package's form, which
    # its tests check at 32 lanes × beam 300)
    write = (torch.arange(u_max, device=dev) == ins_pos.unsqueeze(-1)) \
        & sel_is_ext.unsqueeze(-1)
    new_prefixes = torch.where(write, sel_char.to(torch.int32).unsqueeze(-1),
                               new_prefixes)
    new_lengths = src_lengths + sel_is_ext.to(torch.int64)
    new_last = torch.where(sel_is_ext, sel_char,
                           torch.gather(state.last, 1, sel_src))
    new_hashes = torch.gather(pool_hash, 1, sel)
    dead = top_vals <= NEG_INF / 2
    return BeamState(
        prefixes=new_prefixes,
        lengths=torch.where(dead, 0, new_lengths),
        last=torch.where(dead, -1, new_last),
        hashes=new_hashes,
        p_b=torch.gather(merged_p_b, 1, top_idx),
        p_nb=torch.gather(merged_p_nb, 1, top_idx))


def _masked_step(states, lp_blank, cand, cand_lp, active, top_n, beam_size,
                 lm_bigram, lm_unigram, alpha, beta, merge_mode,
                 lm_hash=None) -> BeamState:
    """One step over the batch; inactive rows keep their state."""
    new = _beam_step(states, lp_blank, cand, cand_lp, top_n, beam_size,
                     lm_bigram, lm_unigram, alpha, beta, merge_mode,
                     lm_hash=lm_hash)
    return BeamState(*(torch.where(
        active.reshape(-1, *([1] * (n.dim() - 1))), n, o)
        for n, o in zip(new, states)))


def beam_search_step_batch(states: BeamState, probs_t, active,
                           blank: int = 0, beam_size: int = 10,
                           cutoff_top_n: int = 40, cutoff_prob: float = 0.99,
                           lm_bigram=None, lm_unigram=None,
                           alpha: float = 2.2, beta: float = 4.3,
                           max_prefix_len: int = 0,
                           merge_mode: str = 'match',
                           lm_hash: Optional[HashLM] = None) -> BeamState:
    """One decode step over the whole batch.
    probs_t: [B, V]; active: [B] bool (frame < utterance length)."""
    lp_blank, cand, cand_lp = precompute_candidates(
        probs_t, blank, cutoff_top_n, cutoff_prob)
    return _masked_step(states, lp_blank, cand, cand_lp, active,
                        cutoff_top_n, beam_size, lm_bigram, lm_unigram,
                        alpha, beta, merge_mode, lm_hash=lm_hash)


def _scan_candidates(states, lp_blank, cand, cand_lp, lens, top_n,
                     beam_size, lm_bigram, lm_unigram, alpha, beta,
                     merge_mode, lm_hash=None, n_steps=None) -> BeamState:
    """Run the beam over precomputed candidates, lp_blank [B, T] and
    cand/cand_lp [B, T, N], for ``n_steps`` frames (all T by default; the
    frames at or past every row's length are inactive steps)."""
    n_steps = lp_blank.shape[1] if n_steps is None else n_steps
    for t in range(n_steps):
        states = _masked_step(states, lp_blank[:, t], cand[:, t],
                              cand_lp[:, t], t < lens, top_n, beam_size,
                              lm_bigram, lm_unigram, alpha, beta,
                              merge_mode, lm_hash=lm_hash)
    return states


def ctc_beam_search(probs, lens, blank: int = 0, beam_size: int = 10,
                    cutoff_top_n: int = 40, cutoff_prob: float = 0.99,
                    lm_bigram=None, lm_unigram=None,
                    alpha: float = 2.2, beta: float = 4.3,
                    max_prefix_len: Optional[int] = None,
                    blank_skip_threshold: float = 1.0,
                    merge_mode: str = 'match',
                    lm_hash: Optional[HashLM] = None) -> BeamState:
    """Batch offline decode: [B, T, V] probs + [B] lens → BeamState batch
    (``ctc_beam_search_jax``). Convert with ``beam_state_to_results``.
    ``blank_skip_threshold < 1`` enables blank-frame compaction."""
    bsz, t_max, _ = probs.shape
    if max_prefix_len is None:
        max_prefix_len = t_max
    lp_blank, cand, cand_lp = precompute_candidates(
        probs, blank, cutoff_top_n, cutoff_prob)
    if blank_skip_threshold < 1.0:
        lp_blank, cand, cand_lp, lens = compact_candidate_frames(
            lp_blank, cand, cand_lp, lens, blank_skip_threshold)
    init = init_beam_state(beam_size, max_prefix_len, bsz, probs.device)
    return _scan_candidates(init, lp_blank, cand, cand_lp, lens,
                            cutoff_top_n, beam_size, lm_bigram, lm_unigram,
                            alpha, beta, merge_mode, lm_hash=lm_hash)


def ctc_beam_search_continue(states: BeamState, probs, lens,
                             blank: int = 0, beam_size: int = 10,
                             cutoff_top_n: int = 40,
                             cutoff_prob: float = 0.99,
                             lm_bigram=None, lm_unigram=None,
                             alpha: float = 2.2, beta: float = 4.3,
                             max_prefix_len: int = 0,
                             merge_mode: str = 'match',
                             lm_hash: Optional[HashLM] = None) -> BeamState:
    """Continue decoding from an existing BeamState (streaming)."""
    lp_blank, cand, cand_lp = precompute_candidates(
        probs, blank, cutoff_top_n, cutoff_prob)
    return _scan_candidates(states, lp_blank, cand, cand_lp, lens,
                            cutoff_top_n, beam_size, lm_bigram, lm_unigram,
                            alpha, beta, merge_mode, lm_hash=lm_hash)


def pack_best_hypothesis(states: BeamState):
    """Each row's best beam packed into ONE int32 tensor [B, 2 + U_max]:
    (score bit pattern, length, prefix tokens), so one device→host read
    yields every result."""
    p_tot = _logaddexp(states.p_b, states.p_nb)            # [B, K]
    best = torch.argmax(p_tot, dim=1)                       # first maximum
    bi = torch.arange(p_tot.shape[0], device=p_tot.device)
    return torch.cat([
        p_tot[bi, best].view(torch.int32)[:, None],
        states.lengths[bi, best].to(torch.int32)[:, None],
        states.prefixes[bi, best]], dim=1)


def all_hypotheses(states: BeamState, max_hyp_len: int):
    """Every beam's hypothesis, for attention rescoring: (prefixes
    [B, K, max_hyp_len] int32, lengths [B, K], ctc_scores [B, K] f32).
    Dead beams carry NEG_INF scores."""
    scores = _logaddexp(states.p_b, states.p_nb)
    lengths = torch.clamp_max(states.lengths, max_hyp_len)
    return states.prefixes[:, :, :max_hyp_len], lengths, scores


def pack_hypothesis_at(states: BeamState, best, scores):
    """Pack the beam ``best[b]`` of each row, with supplied scores (e.g.
    rescored totals), into one int32 tensor [B, 2 + U_max], the layout of
    pack_best_hypothesis."""
    bi = torch.arange(best.shape[0], device=best.device)
    return torch.cat([
        scores[bi, best].to(torch.float32).view(torch.int32)[:, None],
        states.lengths[bi, best].to(torch.int32)[:, None],
        states.prefixes[bi, best]], dim=1)


def unpack_results(packed, vocab_list):
    """Host side of pack_best_hypothesis → list of (score, text)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    scores = packed[:, 0].view(np.float32)
    out = []
    for b in range(packed.shape[0]):
        ids = packed[b, 2:2 + packed[b, 1]]
        out.append((float(scores[b]),
                    ''.join(vocab_list[i] for i in ids)))
    return out


def beam_state_to_results(states: BeamState, vocab_list):
    """BeamState batch → list of (score, text) of each row's best beam."""
    return unpack_results(pack_best_hypothesis(states), vocab_list)


def _bucket(t_needed: int, t_max: int) -> int:
    """The compacted length rounded up to a 64-frame multiple, as the JAX
    decoder buckets it, at most the input's length."""
    return min(max(64, ((t_needed + 63) // 64) * 64), t_max)


class TorchBeamSearchDecoder:
    """Decoder with the BeamSearchDecoder surface, running the search on
    ``device`` (``cuda:0`` unless given; nothing moves it elsewhere).
    Streaming keeps the BeamState on the device across chunks.

    ``decode_batch`` accepts tensors on the device and keeps them there:
    feed it the model's output directly."""

    def __init__(self, vocab_list, alpha: float = 2.2, beta: float = 4.3,
                 beam_size: int = 10, cutoff_prob: float = 0.99,
                 cutoff_top_n: int = 40, blank_index: int = 0,
                 language_model_path: str = None,
                 max_prefix_len: int = 512,
                 blank_skip_threshold: float = 0.98,
                 merge_mode: str = 'match',
                 prune_method: str = 'exact',
                 lm_fusion: str = 'auto', device='cuda:0', **_):
        self.device = torch.device(device)
        self.vocab_list = list(vocab_list)
        self.alpha = alpha
        self.beta = beta
        self.beam_size = beam_size
        self.cutoff_prob = cutoff_prob
        self.cutoff_top_n = min(cutoff_top_n, len(vocab_list))
        self.blank_index = blank_index
        self.max_prefix_len = max_prefix_len
        self.blank_skip_threshold = blank_skip_threshold
        self.merge_mode = merge_mode
        self.prune_method = prune_method
        self.lm_fusion = lm_fusion  # 'auto' | 'dense' | 'hash'
        self.lm_unigram = None
        self.lm_bigram = None
        self.lm_hash = None
        self.frames_decoded = 0     # scan steps run, after compaction
        if language_model_path:
            if os.path.exists(language_model_path):
                self._load_lm(language_model_path)
            else:
                logger.warning(f"language model {language_model_path} not "
                               f"found; decoding without it")
        self.reset()

    def _lm_cache_meta(self, path):
        """Cache key of the flattened LM arrays: the tables depend on the
        ARPA file AND the vocab-id mapping."""
        st = os.stat(path)
        vh = hashlib.sha1(
            '\n'.join(self.vocab_list).encode('utf-8')).hexdigest()
        return np.asarray([st.st_mtime_ns, st.st_size], np.int64), vh

    def _load_lm_hash_cached(self, path):
        """build_hash_tables output, cached in ``<arpa>.tpu_lm.npz`` in the
        JAX package's format (``fmt`` 'chd1'), so a cache written by either
        package loads in the other."""
        cache = path + '.tpu_lm.npz'
        meta, vh = self._lm_cache_meta(path)
        if os.path.exists(cache):
            try:
                z = np.load(cache, allow_pickle=False)
                if (np.array_equal(z['meta'], meta)
                        and str(z['vocab_sha1']) == vh
                        and 'fmt' in z.files and str(z['fmt']) == 'chd1'):
                    n_orders = int(z['n_orders'])
                    return dict(
                        order=int(z['order']),
                        uni_logp=z['uni_logp'], uni_found=z['uni_found'],
                        uni_backoff=z['uni_backoff'],
                        tables=[(z[f'd{i}'], z[f'fp{i}'], z[f'lp{i}'],
                                 z[f'bk{i}']) for i in range(n_orders)])
            except Exception as e:  # unreadable or stale cache: rebuild
                logger.warning(f"ignoring the LM cache {cache}: {e}")
        scorer = NgramScorer(path, self.vocab_list)
        t = build_hash_tables(scorer, self.vocab_list)
        arrs = dict(meta=meta, vocab_sha1=np.str_(vh), fmt=np.str_('chd1'),
                    order=np.int64(t['order']),
                    n_orders=np.int64(len(t['tables'])),
                    uni_logp=t['uni_logp'], uni_found=t['uni_found'],
                    uni_backoff=t['uni_backoff'])
        for i, (d, fp, lp, bk) in enumerate(t['tables']):
            arrs[f'd{i}'] = d
            arrs[f'fp{i}'], arrs[f'lp{i}'], arrs[f'bk{i}'] = fp, lp, bk
        tmp = f'{cache}.{os.getpid()}.tmp.npz'
        try:
            np.savez(tmp, **arrs)
            os.replace(tmp, cache)
        except OSError as e:  # read-only LM directory: serve uncached
            logger.warning(f"cannot write the LM cache {cache}: {e}")
        return t

    def _load_lm(self, path):
        if path.endswith('.klm'):
            # A .klm stores n-grams only as 64-bit hashes, so the vocab-id
            # tables on-device fusion needs cannot be enumerated from it.
            raise ValueError(
                "on-device LM fusion needs an ARPA model; .klm binaries "
                "are supported by the host and native beam-search backends "
                "(ctc_beam_search_decoder_conf.backend: 'host' or 'native')")

        def peek_order(p):
            import gzip
            opener = gzip.open if p.endswith('.gz') else open
            order = 0
            with opener(p, 'rt', encoding='utf-8') as f:
                for line in f:
                    line = line.strip()
                    if line.startswith('ngram '):
                        order = max(order,
                                    int(line[6:line.index('=')]))
                    elif line.startswith('\\1-grams'):
                        break
            return order
        order = peek_order(path)
        if self.lm_fusion == 'hash' or (self.lm_fusion == 'auto'
                                        and order >= 3):
            # orders 3+: the dense [V, V] table can't carry trigram+
            # context; the hash tables keep the full backoff chain
            self.lm_hash = hash_lm_from_tables(
                self._load_lm_hash_cached(path), self.device)
            return
        scorer = NgramScorer(path, self.vocab_list)
        v = len(self.vocab_list)
        uni = np.full((v,), -6.0, np.float32)
        for i, tok in enumerate(self.vocab_list):
            e = scorer.tables.get(1, {}).get((tok,))
            if e is not None:
                uni[i] = e[0]
        self.lm_unigram = torch.from_numpy(uni).to(self.device)
        if 2 in scorer.tables:
            big = np.tile(uni[None, :], (v, 1))  # backoff to unigram
            backoff = np.zeros((v,), np.float32)
            tok_to_id = {t: i for i, t in enumerate(self.vocab_list)}
            for i, tok in enumerate(self.vocab_list):
                e = scorer.tables.get(1, {}).get((tok,))
                if e is not None:
                    backoff[i] = e[1]
            big += backoff[:, None]
            for (a, b), (logp, _bo) in scorer.tables[2].items():
                ia, ib = tok_to_id.get(a), tok_to_id.get(b)
                if ia is not None and ib is not None:
                    big[ia, ib] = logp
            self.lm_bigram = torch.from_numpy(big).to(self.device)

    def tensors(self):
        """The decoder's device tensors: LM tables and streaming state."""
        out = [t for t in (self.lm_unigram, self.lm_bigram) if t is not None]
        if self.lm_hash is not None:
            out += self.lm_hash.tensors()
        if self._state is not None:
            out += list(self._state)
        return out

    # ------------------------------------------------------------ phase 1

    def _f32(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)

    def _lens(self, lens):
        if isinstance(lens, torch.Tensor):
            return lens.to(self.device, torch.int64)
        return torch.from_numpy(np.asarray(lens, np.int64).reshape(-1)).to(
            self.device)

    def prep(self, probs, lens):
        """Phase 1 without compaction."""
        lp_blank, cand, cand_lp = precompute_candidates(
            probs, self.blank_index, self.cutoff_top_n, self.cutoff_prob,
            self.prune_method)
        return lp_blank, cand, cand_lp, lens

    def keep_map(self, probs, lens):
        """Phase 1a: the kept-frame map from the blank column alone, so that
        the vocab-sized top-k only sees frames that survive compaction.
        Returns (src [B, T] kept frame indices left-packed, lp_blank [B, T],
        new_lens, raw_lens); an all-blank row gets new_lens 1, a synthetic
        frame whose candidates gather_topk prunes, so the beam takes a
        stay-only step."""
        t_max = probs.shape[1]
        pb = probs[:, :, self.blank_index]
        keep = (pb < self.blank_skip_threshold) \
            & (torch.arange(t_max, device=pb.device)[None, :]
               < lens[:, None])
        src, written = _pack_map(keep)
        lp_blank = torch.where(written, torch.gather(
            torch.log(torch.clamp_min(pb, 1e-30)), 1, src), 0.0)
        raw_lens = keep.sum(dim=1)
        return (torch.where(written, src, 0), lp_blank,
                torch.clamp_min(raw_lens, 1), raw_lens)

    def gather_topk(self, probs, src_b, raw_lens):
        """Phase 1b: gather the kept rows, then their candidates."""
        _, cand, cand_lp = precompute_candidates(
            _gather_frames(probs, src_b), self.blank_index,
            self.cutoff_top_n, self.cutoff_prob, self.prune_method)
        t_idx = torch.arange(src_b.shape[1], device=src_b.device)
        valid = t_idx[None, :] < raw_lens[:, None]
        return cand, torch.where(valid.unsqueeze(-1), cand_lp, NEG_INF)

    def prep_logits(self, logits, lens):
        """Phase 1 from logits without compaction: the f32 [B, T, V]
        posterior is never made."""
        lse = torch.logsumexp(logits.float(), dim=-1)
        lp_blank = torch.clamp_min(
            logits[..., self.blank_index].float() - lse, math.log(1e-30))
        cand, cand_lp = candidates_from_logits(
            logits, lse, self.blank_index, self.cutoff_top_n,
            self.cutoff_prob, self.prune_method)
        return lp_blank, cand, cand_lp, lens

    def keep_map_logits(self, logits, lens):
        """Phase 1a from logits: one logsumexp and the blank column give the
        keep decision and the packed lp_blank; the per-frame logsumexp is
        packed alongside for phase 1b."""
        t_max = logits.shape[1]
        lse = torch.logsumexp(logits.float(), dim=-1)
        lp_b = torch.clamp_min(
            logits[:, :, self.blank_index].float() - lse, math.log(1e-30))
        keep = (lp_b < math.log(self.blank_skip_threshold)) \
            & (torch.arange(t_max, device=lp_b.device)[None, :]
               < lens[:, None])
        src, written = _pack_map(keep)
        lp_blank = torch.where(written, torch.gather(lp_b, 1, src), 0.0)
        lse_packed = torch.where(written, torch.gather(lse, 1, src), 0.0)
        raw_lens = keep.sum(dim=1)
        return (torch.where(written, src, 0), lp_blank, lse_packed,
                torch.clamp_min(raw_lens, 1), raw_lens)

    def gather_topk_logits(self, logits, lse_packed, src_b, raw_lens):
        """Phase 1b from logits: gather the kept rows, then candidates."""
        cand, cand_lp = candidates_from_logits(
            _gather_frames(logits, src_b), lse_packed, self.blank_index,
            self.cutoff_top_n, self.cutoff_prob, self.prune_method)
        t_idx = torch.arange(src_b.shape[1], device=src_b.device)
        valid = t_idx[None, :] < raw_lens[:, None]
        return cand, torch.where(valid.unsqueeze(-1), cand_lp, NEG_INF)

    # ------------------------------------------------------------ phase 2

    def scan_states(self, lp_blank, cand, cand_lp, lens, n_steps=None):
        init = init_beam_state(self.beam_size, self.max_prefix_len,
                               lp_blank.shape[0], self.device)
        n_steps = lp_blank.shape[1] if n_steps is None else n_steps
        self.frames_decoded += n_steps
        return _scan_candidates(
            init, lp_blank, cand, cand_lp, lens, self.cutoff_top_n,
            self.beam_size, self.lm_bigram, self.lm_unigram, self.alpha,
            self.beta, self.merge_mode, lm_hash=self.lm_hash,
            n_steps=n_steps)

    def _scan_packed(self, prepped):
        return pack_best_hypothesis(self.scan_states(*prepped))

    # ------------------------------------------------------------- offline

    def _prepped(self, probs_batch, lens):
        """Candidates, compaction and the scan length. With compaction on,
        the keep map runs first, the host reads the compacted length (the
        one device→host read) and buckets it to a 64-frame multiple, and
        only then does the vocab-sized top-k run, on the kept rows.
        Returns the scan's inputs and its number of steps."""
        probs = self._f32(probs_batch)
        lens = self._lens(lens)
        if self.blank_skip_threshold >= 1.0:
            return (*self.prep(probs, lens), None)
        src, lp_blank, new_lens, raw_lens = self.keep_map(probs, lens)
        t_needed = int(new_lens.max())
        bucket = _bucket(t_needed, probs.shape[1])
        cand, cand_lp = self.gather_topk(probs, src[:, :bucket], raw_lens)
        return lp_blank[:, :bucket], cand, cand_lp, new_lens, t_needed

    def decode_batch(self, probs_batch, lens):
        return unpack_results(self._scan_packed(
            self._prepped(probs_batch, lens)), self.vocab_list)

    def decode_batch_states(self, probs_batch, lens) -> BeamState:
        """Batch decode returning the device-resident BeamState (all K
        hypotheses), for attention rescoring."""
        return self.scan_states(*self._prepped(probs_batch, lens))

    # ------------------------------------------------- softmax-free path

    def _begin_from_logits(self, logits, lens):
        """Enqueue phase 1a from CTC logits without a host read; the
        compacted length is read later, in _bucket_from_logits, so a caller
        holding several batches can overlap one batch's device work with
        the previous batch's host read (decode_batches_pipelined)."""
        logits = logits if isinstance(logits, torch.Tensor) \
            else torch.from_numpy(np.asarray(logits))
        logits = logits.to(self.device)
        lens = self._lens(lens)
        if self.blank_skip_threshold >= 1.0:
            return ('nocompact', (*self.prep_logits(logits, lens), None))
        src, lp_blank, lse_p, new_lens, raw_lens = \
            self.keep_map_logits(logits, lens)
        return ('compact', logits, src, lp_blank, lse_p, new_lens,
                raw_lens, new_lens.max())

    def _bucket_from_logits(self, handle):
        """Finish phase 1 of a _begin_from_logits handle: read the
        compacted length on the host (the one device→host read), bucket
        it, and run the vocab-sized top-k on the kept rows only."""
        if handle[0] == 'nocompact':
            return handle[1]
        (_, logits, src, lp_blank, lse_p, new_lens, raw_lens,
         t_needed_dev) = handle
        t_needed = int(t_needed_dev)
        bucket = _bucket(t_needed, logits.shape[1])
        cand, cand_lp = self.gather_topk_logits(
            logits, lse_p[:, :bucket], src[:, :bucket], raw_lens)
        return lp_blank[:, :bucket], cand, cand_lp, new_lens, t_needed

    def _prepped_from_logits(self, logits, lens):
        """Phase 1 straight from CTC logits (model.get_encoder_logits)."""
        return self._bucket_from_logits(self._begin_from_logits(logits,
                                                                lens))

    def decode_batch_from_logits(self, logits, lens):
        return unpack_results(self._scan_packed(
            self._prepped_from_logits(logits, lens)), self.vocab_list)

    def decode_batches_pipelined(self, batches, fwd=None):
        """Software-pipelined batch decode over an iterable of batches,
        yielding each batch's list of (score, text) in order.

        ``batches`` yields (logits, lens) pairs, or items that ``fwd`` maps
        to such a pair (e.g. the encoder call). Batch i+1's phase 1a is
        enqueued before batch i's compacted-length read, and batch i-1's
        packed results are read while both compute."""
        pend_bucket = deque()   # handles awaiting the length read + scan
        pend_unpack = deque()   # packed device tensors awaiting host read
        for item in batches:
            pair = fwd(item) if fwd is not None else item
            pend_bucket.append(self._begin_from_logits(*pair))
            if len(pend_bucket) >= 2:
                pend_unpack.append(self._scan_packed(
                    self._bucket_from_logits(pend_bucket.popleft())))
            if len(pend_unpack) >= 2:
                yield unpack_results(pend_unpack.popleft(),
                                     self.vocab_list)
        while pend_bucket:
            pend_unpack.append(self._scan_packed(
                self._bucket_from_logits(pend_bucket.popleft())))
        while pend_unpack:
            yield unpack_results(pend_unpack.popleft(), self.vocab_list)

    def decode_batch_states_from_logits(self, logits, lens) -> BeamState:
        return self.scan_states(*self._prepped_from_logits(logits, lens))

    def decode(self, probs):
        if not isinstance(probs, torch.Tensor):
            probs = np.asarray(probs)
        return self.decode_batch(probs[None], [probs.shape[0]])[0]

    # ------------------------------------------------------------ streaming

    def reset(self):
        self._state = None
        self._last_result = None

    def decode_chunk(self, chunk_probs):
        """Feed a chunk of [T, V] posteriors (host array); frames whose
        blank probability reaches the threshold are dropped on the host,
        the rest advance the beam on the device. Returns the best (score,
        text) so far."""
        probs = np.asarray(chunk_probs, np.float32)
        if probs.size and self.blank_skip_threshold < 1.0:
            probs = probs[probs[:, self.blank_index]
                          < self.blank_skip_threshold]
        if probs.size:
            if self._state is None:
                self._state = init_beam_state(
                    self.beam_size, self.max_prefix_len, 1, self.device)
            t = probs.shape[0]
            self.frames_decoded += t
            self._state = ctc_beam_search_continue(
                self._state, self._f32(probs[None]), self._lens([t]),
                blank=self.blank_index, beam_size=self.beam_size,
                cutoff_top_n=self.cutoff_top_n,
                cutoff_prob=self.cutoff_prob,
                lm_bigram=self.lm_bigram, lm_unigram=self.lm_unigram,
                alpha=self.alpha, beta=self.beta,
                max_prefix_len=self.max_prefix_len,
                merge_mode=self.merge_mode, lm_hash=self.lm_hash)
            self._last_result = beam_state_to_results(self._state,
                                                      self.vocab_list)[0]
        return self.current()

    def current(self):
        if self._state is None:
            return 0.0, ''
        if self._last_result is not None:
            return self._last_result
        return beam_state_to_results(self._state, self.vocab_list)[0]
