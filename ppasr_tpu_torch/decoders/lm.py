"""Character n-gram language model for beam-search shallow fusion (copy of
ppasr_tpu/decoders/lm.py, numpy only; tests/test_torch_lm.py pins it to the
original).

Loads a standard ARPA file (text or gzip) into backoff tables and answers
``score(prefix_ids, new_id) -> log10 P(new | prefix)`` with full backoff.
Mandarin models in this stack are char-level, so tokens are scored directly;
`<space>` maps to a word boundary for English models.

KenLM ``.klm`` probing binaries are read natively: ``load_scorer``
dispatches them to :class:`~ppasr_tpu_torch.decoders.klm.KlmScorer`;
everything else is parsed as ARPA here. ``build_hash_tables`` flattens an
ARPA model into the CHD perfect-hash tables that the on-device search
(``beam_search_torch``) probes.
"""
import gzip
import math

import numpy as np


def load_scorer(language_model_path: str, vocab_list):
    """LM factory: `.klm` (KenLM probing binary) → :class:`KlmScorer`;
    anything else is parsed as ARPA (text or gzip) → :class:`NgramScorer`.
    Both expose ``score(prefix_ids, new_id) -> log10`` with identical
    backoff semantics."""
    if language_model_path.endswith('.klm'):
        from ppasr_tpu_torch.decoders.klm import KlmScorer
        return KlmScorer(language_model_path, vocab_list)
    return NgramScorer(language_model_path, vocab_list)


class NgramScorer:
    def __init__(self, arpa_path: str, vocab_list):
        self.vocab_list = list(vocab_list)
        # tables[n] : dict ngram-tuple(str) -> (log10 prob, log10 backoff)
        self.tables = {}
        self.order = 0
        self._load_arpa(arpa_path)

    def _open(self, path):
        if path.endswith('.gz'):
            return gzip.open(path, 'rt', encoding='utf-8')
        return open(path, 'r', encoding='utf-8')

    def _load_arpa(self, path):
        section = 0
        with self._open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith('\\') and '-grams:' in line:
                    section = int(line[1:line.index('-')])
                    self.order = max(self.order, section)
                    self.tables.setdefault(section, {})
                    continue
                if line.startswith('\\') or line.startswith('ngram '):
                    if line == '\\end\\':
                        break
                    continue
                if section == 0:
                    continue
                parts = line.split('\t')
                if len(parts) < 2:
                    continue
                logp = float(parts[0])
                tokens = tuple(parts[1].split(' '))
                backoff = float(parts[2]) if len(parts) > 2 else 0.0
                self.tables[section][tokens] = (logp, backoff)

    def _score_tokens(self, context: tuple, token: str) -> float:
        """log10 P(token | context) with backoff."""
        for n in range(min(len(context) + 1, self.order), 0, -1):
            ngram = context[-(n - 1):] + (token,) if n > 1 else (token,)
            entry = self.tables.get(n, {}).get(ngram)
            if entry is not None:
                logp = entry[0]
                # add backoff weights of the skipped longer contexts
                return logp + self._backoff_sum(context, n)
        # OOV: harsh fixed penalty
        return -6.0

    def _backoff_sum(self, context: tuple, matched_order: int) -> float:
        """Sum of backoff weights for contexts longer than the matched one."""
        total = 0.0
        max_ctx = min(len(context), self.order - 1)
        for n in range(matched_order, max_ctx + 1):
            ctx = context[-n:]
            entry = self.tables.get(n, {}).get(ctx)
            if entry is not None:
                total += entry[1]
        return total

    def score(self, prefix_ids, new_id: int) -> float:
        """log10 P(new | prefix) over vocab ids (char tokens)."""
        context = tuple(self.vocab_list[i] for i in prefix_ids[-(self.order - 1):]) \
            if self.order > 1 else ()
        token = self.vocab_list[new_id]
        return self._score_tokens(context, token)

    def token_log10_matrix(self, max_order_context):
        """Flatten the LM into dense arrays for on-device fusion (unigram +
        bigram tables); higher orders fall back to host scoring."""
        v = len(self.vocab_list)
        uni = np.full((v,), -6.0, np.float32)
        for i, tok in enumerate(self.vocab_list):
            e = self.tables.get(1, {}).get((tok,))
            if e is not None:
                uni[i] = e[0]
        return uni


# ------------------------------------------------------------------ device
# Probing hash tables for on-device fusion of orders > 2 (the dense [V, V]
# bigram table stops scaling past order 2). One open-addressing table per
# order n >= 2: 32-bit fingerprints (0 = empty), log10 prob, backoff weight.
# The beam step probes these with tensor gathers
# (beam_search_torch._hash_lm_score) using the SAME fold hash as _fold_hash
# below — keep the two in sync.

_H1_SEED, _H1_MULT = 2166136261, 0x9E3779B1
_H2_SEED, _H2_MULT = 0x27220A95, 0x85EBCA6B
_U32 = 0xFFFFFFFF


def _fmix32(h):
    """Murmur3 avalanche. The raw fold is linear in the last token, so
    neighboring candidate ids would otherwise produce adjacent slot hashes
    AND fingerprints (which the |1 low bit then conflates)."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    h ^= h >> 16
    return h


def _fold_hash(ids):
    """(slot hash, fingerprint hash) over token ids, 32-bit wrapping —
    bit-identical to the masked int64 fold on the device
    (beam_search_torch._hash_fold)."""
    h1, h2 = _H1_SEED, _H2_SEED
    for i in ids:
        t = (int(i) + 1) & _U32
        h1 = (h1 * _H1_MULT + t) & _U32
        h2 = (h2 * _H2_MULT + t) & _U32
    return _fmix32(h1), _fmix32(h2)


def _fmix32_np(h):
    """Vectorized murmur3 avalanche over a uint32 numpy array (wrapping
    arithmetic; numpy unsigned mults wrap mod 2^32)."""
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _build_chd(h1s, h2s, bucket_ratio=4, start_m=None):
    """CHD-style perfect-hash placement: bucket by h1, then per-bucket
    displacement d so slot = fmix32(h2 ^ d) & (M-1) is collision-free.

    Device lookups cost exactly 2 gathers (d-table + slot) instead of up
    to 8 linear probes — the probe chain was the dominant decode cost with
    an LM fused (STATUS r1 perf notes: 2.5k → 0.8k audio-s/s at B=16).

    Returns (d_table u32 [B], slots int64 [n]) with slots[i] the placed
    position of key i, or None when a displacement can't be found at this
    table size (caller grows M and retries)."""
    n = len(h1s)
    b_count = max(64, 1 << int(np.ceil(np.log2(max(n, 1) / bucket_ratio
                                                + 1))))
    m = start_m
    bucket = (h1s & np.uint32(b_count - 1)).astype(np.int64)
    order_idx = np.argsort(bucket, kind='stable')
    bounds = np.searchsorted(bucket[order_idx], np.arange(b_count + 1))
    # process buckets largest-first: big buckets need the most freedom
    sizes = bounds[1:] - bounds[:-1]
    d_table = np.zeros((b_count,), np.uint32)
    used = np.zeros((m,), bool)
    slots_out = np.empty((n,), np.int64)
    mask = np.uint32(m - 1)
    for b in np.argsort(-sizes):
        if sizes[b] == 0:
            continue
        keys = order_idx[bounds[b]:bounds[b + 1]]
        h2 = h2s[keys]
        for d in range(1, 65536):
            slots = _fmix32_np(h2 ^ np.uint32(d)) & mask
            if len(np.unique(slots)) != len(slots) or used[slots].any():
                continue
            used[slots] = True
            d_table[b] = d
            slots_out[keys] = slots
            break
        else:
            return None, None
    return d_table, slots_out


def build_hash_tables(scorer: NgramScorer, vocab_list, max_order=None):
    """Flatten an NgramScorer into device-friendly CHD perfect-hash tables.

    Returns a dict of numpy arrays:
      order        int (min(scorer.order, max_order))
      uni_logp     [V] f32 (log10, -6.0 for tokens absent from the LM)
      uni_found    [V] bool
      uni_backoff  [V] f32 (log10 backoff weight, 0 when absent)
      tables       list over n = 2..order of (d u32 [B], fp u32 [M],
                   logp f32 [M], backoff f32 [M]); B, M powers of two.
                   Device lookup: d = d_tbl[h1 & (B-1)], slot =
                   fmix32(h2 ^ d) & (M-1), hit iff fp[slot] == (h2 | 1) —
                   exactly one slot inspected per query (the old scheme
                   linearly probed up to 8).

    n-grams containing tokens outside vocab_list (<s>, </s>, pruned chars)
    are dropped — the host scorer can never query them either, since its
    contexts come from vocab ids (NgramScorer.score). Full-(h1, h2) hash
    collisions between distinct n-grams (~2^-50 per pair) drop the later
    entry: such pairs were already indistinguishable to the fingerprint
    check at query time.
    """
    order = scorer.order if max_order is None else min(scorer.order,
                                                       max_order)
    tok_to_id = {t: i for i, t in enumerate(vocab_list)}
    v = len(vocab_list)
    uni_logp = np.full((v,), -6.0, np.float32)
    uni_found = np.zeros((v,), bool)
    uni_backoff = np.zeros((v,), np.float32)
    for i, tok in enumerate(vocab_list):
        e = scorer.tables.get(1, {}).get((tok,))
        if e is not None:
            uni_logp[i], uni_backoff[i] = e[0], e[1]
            uni_found[i] = True

    tables = []
    for n in range(2, order + 1):
        seen = {}
        h1l, h2l, lpl, bkl = [], [], [], []
        for ngram, (logp, bo) in scorer.tables.get(n, {}).items():
            ids = [tok_to_id.get(w) for w in ngram]
            if None in ids:
                continue
            h1, h2 = _fold_hash(ids)
            if (h1, h2) in seen:
                continue
            seen[(h1, h2)] = True
            h1l.append(h1)
            h2l.append(h2)
            lpl.append(logp)
            bkl.append(bo)
        h2s = np.asarray(h2l, np.uint32)
        n_keys = len(h1l)
        m = 64
        while m < 2 * max(n_keys, 1):
            m *= 2
        while True:
            if n_keys == 0:
                d_tbl = np.zeros((64,), np.uint32)
                slots = np.empty((0,), np.int64)
                break
            d_tbl, slots = _build_chd(np.asarray(h1l, np.uint32),
                                      np.asarray(h2l, np.uint32),
                                      start_m=m)
            if d_tbl is not None:
                break
            m *= 2
            if m > (1 << 31):
                raise RuntimeError("LM CHD build failed to converge")
        fp = np.zeros((m,), np.uint32)
        lp = np.zeros((m,), np.float32)
        bk = np.zeros((m,), np.float32)
        if n_keys:
            fp[slots] = h2s | np.uint32(1)  # fp 0 = empty sentinel
            lp[slots] = np.asarray(lpl, np.float32)
            bk[slots] = np.asarray(bkl, np.float32)
        tables.append((d_tbl, fp, lp, bk))
    return dict(order=order, uni_logp=uni_logp, uni_found=uni_found,
                uni_backoff=uni_backoff, tables=tables)
