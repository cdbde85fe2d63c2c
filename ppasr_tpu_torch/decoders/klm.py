"""KenLM ``.klm`` binary n-gram model: reader, writer, and scorer (copy of
ppasr_tpu/decoders/klm.py, numpy only; tests/test_torch_lm.py pins it to the
original).

Speech-recognition stacks publish their n-gram models as KenLM *probing*
binaries (``zh_giga.no_cna_cmn.prune01244.klm``, named by
configs/conformer.yml). This module implements that binary format natively
(format version 5, ModelType PROBING), so such ``.klm`` artifacts load
here without KenLM:

- :func:`read_klm` mmaps the file and returns the probing tables as numpy
  arrays (vocab hash table, unigram prob/backoff array, one open-addressing
  hash table per higher order).
- :class:`KlmScorer` exposes the same ``score(prefix_ids, new_id) -> log10``
  interface as :class:`ppasr_tpu_torch.decoders.lm.NgramScorer`, with identical
  Katz-backoff semantics (validated by round-trip tests).
- :func:`write_klm` converts a loaded ARPA model into the same layout
  (KenLM's ``build_binary`` analog) — used to build test fixtures and to
  speed up repeated loads of large ARPA models.

Layout implemented (kenlm lm/binary_format.cc, lm/vocab.cc,
lm/search_hashed.hh, util/probing_hash_table.hh):

    [Sanity 88 B: magic "mmap lm ... version 5", float/int sentinels]
    [FixedWidthParameters 20 B: order, probing_multiplier, model_type,
     has_vocabulary, search_version]
    [counts: order x uint64]                (then pad to 8)
    [vocab: 8 B header {version, bound} + probing table of
     {uint64 murmur64a(word), uint32 id} entries, 12 B each]
    [unigrams: (counts[0] + 1) x {float prob, float backoff}]
    [middle order n=2..N-1: probing table of {uint64 key, float prob,
     float backoff}, 16 B each]
    [longest order N: probing table of {uint64 key, float prob}, 12 B each]
    [optional trailing \\0-separated vocab strings when has_vocabulary]

The n-gram key is KenLM's chained word hash over word ids, newest word
first: ``h = id[n-1]; h = h * 8978948897894561157 + id[i]`` for i = n-2..0.
Probing tables use ``ideal = key % buckets`` with linear probing and key 0
as the empty sentinel; ``buckets = max(entries + 1,
int(probing_multiplier * entries))``.

Because no KenLM installation exists in this environment, the reader
validates its section offsets against the file (finite unigram probs,
non-positive log10 values) and raises a descriptive error on mismatch
rather than returning garbage.
"""
import math
import mmap
import struct

import numpy as np

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\0"
MAGIC_PAD = 56  # ALIGN8(len(MAGIC) = 52)
SANITY_SIZE = 88
PARAMS_SIZE = 20
MODEL_PROBING = 0
CHAIN_MULT = 8978948897894561157  # kenlm detail::CombineWordHash
U64 = (1 << 64) - 1
DEFAULT_MULTIPLIER = 1.5


def _align8(x: int) -> int:
    return (x + 7) & ~7


# ----------------------------------------------------------------- murmur

def murmur_hash64a(data: bytes, seed: int = 0) -> int:
    """util::MurmurHash64A — hashes vocab word strings."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ ((len(data) * m) & U64)) & U64
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i:i + 8], 'little')
        k = (k * m) & U64
        k ^= k >> r
        k = (k * m) & U64
        h = ((h ^ k) * m) & U64
    rest = data[n8:]
    if rest:
        h ^= int.from_bytes(rest, 'little')
        h = (h * m) & U64
    h ^= h >> r
    h = (h * m) & U64
    h ^= h >> r
    return h


def chained_hash(word_ids) -> int:
    """KenLM n-gram key: newest word first, extended back through context."""
    it = list(word_ids)
    h = int(it[-1]) & U64
    for w in reversed(it[:-1]):
        h = (h * CHAIN_MULT + int(w)) & U64
    return h


def _buckets(entries: int, multiplier: float) -> int:
    return max(entries + 1, int(multiplier * float(entries)))


# ----------------------------------------------------------------- writer

def write_klm(path: str, order: int, unigrams, ngrams, vocab_words,
              probing_multiplier: float = DEFAULT_MULTIPLIER,
              include_vocab_strings: bool = True):
    """Write a KenLM probing binary.

    ``unigrams``: list of (word, log10 prob, log10 backoff) in ARPA order
    (may or may not contain <unk>; ids are assigned as KenLM does: <unk>=0,
    others in order of appearance starting at 1).
    ``ngrams``: dict n -> list of (tuple-of-words, log10 prob, log10 backoff)
    for n = 2..order (backoff ignored for n == order).
    ``vocab_words``: unused words are fine; only unigram words get ids.
    """
    word_id = {'<unk>': 0, '<UNK>': 0}
    id_words = ['<unk>']
    uni_entries = []
    for w, p, b in unigrams:
        if w in ('<unk>', '<UNK>'):
            uni_entries.append((0, p, b))
            continue
        wid = word_id.setdefault(w, len(id_words))
        if wid == len(id_words):
            id_words.append(w)
        uni_entries.append((wid, p, b))
    bound = len(id_words)
    counts = [len(unigrams)] + [len(ngrams.get(n, []))
                                for n in range(2, order + 1)]

    # --- header ---
    out = bytearray()
    out += MAGIC.ljust(MAGIC_PAD, b'\0')
    out += struct.pack('<fff', 0.0, 1.0, -0.5)
    out += struct.pack('<II', 1, 0xFFFFFFFF)
    out += b'\0' * 4                      # pad to 8-align the uint64
    out += struct.pack('<Q', 1)
    assert len(out) == SANITY_SIZE
    out += struct.pack('<B3xfi B3x I', order, probing_multiplier,
                       MODEL_PROBING, 1 if include_vocab_strings else 0, 0)
    assert len(out) == SANITY_SIZE + PARAMS_SIZE
    for c in counts:
        out += struct.pack('<Q', c)
    out += b'\0' * (_align8(len(out)) - len(out))

    # --- vocab probing table ---
    out += struct.pack('<II', 0, bound)   # ProbingVocabularyHeader
    n_words = bound - 1                   # <unk> is not stored
    vb = _buckets(n_words, probing_multiplier)
    vkeys = np.zeros(vb, np.uint64)
    vvals = np.zeros(vb, np.uint32)
    for w in id_words[1:]:
        h = murmur_hash64a(w.encode('utf-8'))
        s = h % vb
        while int(vkeys[s]) != 0:
            s = (s + 1) % vb
        vkeys[s] = h
        vvals[s] = word_id[w]
    ventry = np.zeros(vb, dtype=np.dtype([('k', '<u8'), ('v', '<u4')]))
    ventry['k'] = vkeys
    ventry['v'] = vvals
    out += ventry.tobytes()

    # --- unigram array (+1 hallucinated slot, kenlm search_hashed) ---
    uni = np.zeros(bound + 1, dtype=np.dtype([('p', '<f4'), ('b', '<f4')]))
    for wid, p, b in uni_entries:
        uni['p'][wid] = p
        uni['b'][wid] = b
    out += uni.tobytes()

    # --- middle + longest probing tables ---
    for n in range(2, order + 1):
        entries = ngrams.get(n, [])
        nb = _buckets(len(entries), probing_multiplier)
        is_longest = (n == order)
        dt = np.dtype([('k', '<u8'), ('p', '<f4')]) if is_longest else \
            np.dtype([('k', '<u8'), ('p', '<f4'), ('b', '<f4')])
        table = np.zeros(nb, dtype=dt)
        for words, p, b in entries:
            ids = [word_id.get(w, 0) for w in words]
            h = chained_hash(ids)
            if h == 0:
                h = 1  # never collide with the empty sentinel
            s = h % nb
            while int(table['k'][s]) != 0:
                s = (s + 1) % nb
            table['k'][s] = h
            table['p'][s] = p
            if not is_longest:
                table['b'][s] = b
        out += table.tobytes()

    if include_vocab_strings:
        out += b'\0'.join(w.encode('utf-8') for w in id_words) + b'\0'

    with open(path, 'wb') as f:
        f.write(bytes(out))
    return counts


def write_klm_from_scorer(path: str, scorer,
                          probing_multiplier: float = DEFAULT_MULTIPLIER):
    """ARPA → .klm using a loaded :class:`NgramScorer` (its ``tables`` hold
    ``{n: {tuple(words): (log10 p, log10 backoff)}}``)."""
    unigrams = [(w[0], p, b) for w, (p, b) in
                scorer.tables.get(1, {}).items()]
    if not any(w in ('<unk>', '<UNK>') for w, _, _ in unigrams):
        unigrams.insert(0, ('<unk>', -6.0, 0.0))
    ngrams = {n: [(words, p, b) for words, (p, b) in
                  scorer.tables.get(n, {}).items()]
              for n in range(2, scorer.order + 1)}
    return write_klm(path, scorer.order, unigrams, ngrams,
                     [w for w, _, _ in unigrams],
                     probing_multiplier=probing_multiplier)


# ----------------------------------------------------------------- reader

class KlmModel:
    """Parsed .klm probing model with numpy lookup tables."""

    def __init__(self, path: str):
        with open(path, 'rb') as f:
            self._buf = f.read()
        buf = self._buf
        if buf[:len(MAGIC)] != MAGIC:
            head = bytes(buf[:32])
            if head.startswith(b'mmap lm'):
                raise ValueError(
                    f"unsupported kenlm binary format version: "
                    f"{head!r} (this reader implements version 5)")
            raise ValueError(f"{path} is not a kenlm binary (.klm) file")
        zero, one, half = struct.unpack_from('<fff', buf, MAGIC_PAD)
        if (zero, one, half) != (0.0, 1.0, -0.5):
            raise ValueError("kenlm sanity floats mismatch — file written "
                             "on an incompatible architecture")
        (order, multiplier, model_type, has_vocab, search_version
         ) = struct.unpack_from('<B3xfi B3x I', buf, SANITY_SIZE)
        if model_type not in (MODEL_PROBING,):
            names = {1: 'REST_PROBING', 2: 'TRIE', 3: 'QUANT_TRIE',
                     4: 'ARRAY_TRIE', 5: 'QUANT_ARRAY_TRIE'}
            raise ValueError(
                f"kenlm ModelType {names.get(model_type, model_type)} not "
                f"supported (only PROBING; rebuild with `build_binary "
                f"probing`)")
        off = SANITY_SIZE + PARAMS_SIZE
        counts = list(struct.unpack_from(f'<{order}Q', buf, off))
        off = _align8(off + 8 * order)

        self.order = order
        self.counts = counts
        self.multiplier = multiplier

        # vocab
        vversion, bound = struct.unpack_from('<II', buf, off)
        off += 8
        vb = _buckets(bound - 1, multiplier)
        vdt = np.dtype([('k', '<u8'), ('v', '<u4')])
        vtab = np.frombuffer(buf, vdt, count=vb, offset=off)
        off += vb * vdt.itemsize
        self.vocab_keys = vtab['k']
        self.vocab_vals = vtab['v']
        self.bound = bound

        # unigrams
        udt = np.dtype([('p', '<f4'), ('b', '<f4')])
        uni = np.frombuffer(buf, udt, count=bound + 1, offset=off)
        off += (bound + 1) * udt.itemsize
        self.uni_prob = uni['p'][:bound]
        self.uni_backoff = uni['b'][:bound]
        if not np.all(np.isfinite(self.uni_prob[1:])) or \
                np.any(self.uni_prob[1:] > 1e-4):
            raise ValueError(
                "unigram section failed validation (non-finite or positive "
                "log10 probs) — unsupported kenlm build variant")

        # middle + longest
        self.tables = {}
        for n in range(2, order + 1):
            is_longest = (n == order)
            dt = np.dtype([('k', '<u8'), ('p', '<f4')]) if is_longest \
                else np.dtype([('k', '<u8'), ('p', '<f4'), ('b', '<f4')])
            nb = _buckets(counts[n - 1], multiplier)
            tab = np.frombuffer(buf, dt, count=nb, offset=off)
            off += nb * dt.itemsize
            self.tables[n] = tab

        self.vocab_strings = None
        if has_vocab and off < len(buf):
            raw = bytes(buf[off:])
            words = raw.split(b'\0')
            self.vocab_strings = [w.decode('utf-8', 'replace')
                                  for w in words if w]

    # --- lookups ---

    def word_id(self, word: str) -> int:
        """Vocab probe; 0 (<unk>) on miss."""
        h = murmur_hash64a(word.encode('utf-8'))
        vb = len(self.vocab_keys)
        s = h % vb
        while True:
            k = int(self.vocab_keys[s])
            if k == h:
                return int(self.vocab_vals[s])
            if k == 0:
                return 0
            s = (s + 1) % vb

    def lookup(self, word_ids):
        """(log10 prob, log10 backoff, found) of an n-gram of word ids."""
        n = len(word_ids)
        if n == 1:
            wid = int(word_ids[0])
            if wid >= self.bound:
                return 0.0, 0.0, False
            return (float(self.uni_prob[wid]), float(self.uni_backoff[wid]),
                    True)
        tab = self.tables.get(n)
        if tab is None:
            return 0.0, 0.0, False
        h = chained_hash(word_ids)
        if h == 0:
            h = 1
        nb = len(tab)
        s = h % nb
        while True:
            k = int(tab['k'][s])
            if k == h:
                bo = float(tab['b'][s]) if n < self.order else 0.0
                return float(tab['p'][s]), bo, True
            if k == 0:
                return 0.0, 0.0, False
            s = (s + 1) % nb


class KlmScorer:
    """NgramScorer-compatible scorer over a .klm binary.

    Same interface and backoff semantics as
    :class:`ppasr_tpu_torch.decoders.lm.NgramScorer` (score == the ARPA path for
    round-tripped models): log10 P with Katz backoff, fixed −6.0 for tokens
    the LM has never seen.
    """

    def __init__(self, klm_path: str, vocab_list):
        self.model = KlmModel(klm_path)
        self.vocab_list = list(vocab_list)
        self.order = self.model.order
        # token id (ASR vocab) -> kenlm word id; -1 marks OOV (distinct from
        # kenlm's <unk>=0 so OOVs get the same -6.0 the ARPA path applies)
        self._wid = np.array(
            [self._resolve(tok) for tok in self.vocab_list], np.int64)

    def _resolve(self, tok: str) -> int:
        wid = self.model.word_id(tok)
        return wid if wid != 0 else -1

    def score(self, prefix_ids, new_id: int) -> float:
        wid = int(self._wid[new_id])
        if wid < 0:
            return -6.0
        ctx = [int(self._wid[i])
               for i in prefix_ids[-(self.order - 1):]] \
            if self.order > 1 else []
        ctx = [w for w in ctx if w >= 0]
        for n in range(min(len(ctx) + 1, self.order), 0, -1):
            ngram = ctx[len(ctx) - (n - 1):] + [wid] if n > 1 else [wid]
            p, _, found = self.model.lookup(ngram)
            if found:
                return p + self._backoff_sum(ctx, n)
        return -6.0

    def _backoff_sum(self, ctx, matched_order: int) -> float:
        total = 0.0
        max_ctx = min(len(ctx), self.order - 1)
        for n in range(matched_order, max_ctx + 1):
            _, bo, found = self.model.lookup(ctx[len(ctx) - n:])
            if found:
                total += bo
        return total
