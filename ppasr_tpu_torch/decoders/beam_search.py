"""CTC prefix beam search with optional LM shallow fusion, on the host (copy
of ppasr_tpu/decoders/beam_search.py, numpy only; this is
``backend: 'host'``, and tests/test_torch_decoders_host.py pins it to the
original).

The config surface of the C++ ``paddlespeech_ctcdecoders``:
- offline single/batch decoding with ``beam_size``, ``cutoff_prob``,
  ``cutoff_top_n`` pruning and KenLM shallow fusion weights ``alpha`` (LM)
  and ``beta`` (word-count bonus);
- STATEFUL streaming decoding (``decode_chunk``/``reset``) matching the
  ``CtcBeamSearchDecoderBatch.next()/decode()`` contract — beam state is
  carried incrementally across chunks (O(T) over a stream).

This module is the host (numpy) implementation — the correctness oracle for
the vectorized on-device decoder (beam_search_torch.py) and for LM-fusion
parity. The scorer protocol accepts any object with
``score(prefix_ids, new_id) -> log10 prob`` (see lm.py for the n-gram ARPA
implementation standing in for KenLM).
"""
import math
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LOG0 = -float('inf')


def _logsumexp(*xs):
    m = max(xs)
    if m == LOG0:
        return LOG0
    return m + math.log(sum(math.exp(x - m) for x in xs))


def _lm_bonus(scorer, prefix, c, alpha, beta):
    if scorer is None:
        return 0.0
    # KenLM-style: alpha * log10 P(c | prefix) (in nats) + beta word bonus
    return alpha * scorer.score(prefix, c) * math.log(10) \
        + beta * math.log(10)


def _prune_candidates(row, cutoff_prob, cutoff_top_n):
    """Smallest token set whose cumulative prob reaches cutoff_prob, capped
    at cutoff_top_n (the C++ decoder's pruning)."""
    order = np.argsort(row)[::-1]
    cum = np.cumsum(row[order])
    n_keep = int(np.searchsorted(cum, cutoff_prob) + 1)
    n_keep = min(n_keep, cutoff_top_n, len(order))
    return order[:n_keep]


def _beam_step(beams, row, blank, cutoff_prob, cutoff_top_n, beam_size,
               scorer, alpha, beta):
    """One CTC prefix-beam-search time step.
    ``beams``: dict prefix → (p_blank, p_non_blank) in log domain."""
    log_row = np.log(np.clip(row, 1e-30, 1.0))
    cand = _prune_candidates(row, cutoff_prob, cutoff_top_n)
    new_beams = defaultdict(lambda: [LOG0, LOG0])
    for prefix, (p_b, p_nb) in beams.items():
        p_tot = _logsumexp(p_b, p_nb)
        for c in cand:
            c = int(c)
            lp = float(log_row[c])
            if c == blank:
                nb = new_beams[prefix]
                nb[0] = _logsumexp(nb[0], p_tot + lp)
                continue
            last = prefix[-1] if prefix else None
            if c == last:
                # repeat char: extends the non-blank path in place; a new
                # token is only emitted after an intervening blank
                nb = new_beams[prefix]
                nb[1] = _logsumexp(nb[1], p_nb + lp)
                ext = prefix + (c,)
                bonus = _lm_bonus(scorer, prefix, c, alpha, beta)
                nb2 = new_beams[ext]
                nb2[1] = _logsumexp(nb2[1], p_b + lp + bonus)
            else:
                ext = prefix + (c,)
                bonus = _lm_bonus(scorer, prefix, c, alpha, beta)
                nb2 = new_beams[ext]
                nb2[1] = _logsumexp(nb2[1], p_tot + lp + bonus)
    scored = sorted(new_beams.items(),
                    key=lambda kv: _logsumexp(*kv[1]), reverse=True)
    return {k: tuple(v) for k, v in scored[:beam_size]}


def ctc_prefix_beam_search(probs: np.ndarray,
                           beam_size: int = 300,
                           blank: int = 0,
                           cutoff_prob: float = 0.99,
                           cutoff_top_n: int = 40,
                           scorer=None,
                           alpha: float = 2.2,
                           beta: float = 4.3):
    """[T, V] frame posteriors → list of (score, prefix_tuple), best first."""
    beams = {(): (0.0, LOG0)}
    for t in range(probs.shape[0]):
        beams = _beam_step(beams, probs[t], blank, cutoff_prob,
                           cutoff_top_n, beam_size, scorer, alpha, beta)
    results = [(_logsumexp(*v), k) for k, v in beams.items()]
    results.sort(key=lambda x: x[0], reverse=True)
    return results


class BeamSearchDecoder:
    """Offline + streaming prefix beam search with the C++ decoder's config
    surface."""

    def __init__(self, vocab_list, alpha: float = 2.2, beta: float = 4.3,
                 beam_size: int = 300, num_processes: int = 10,
                 cutoff_prob: float = 0.99, cutoff_top_n: int = 40,
                 language_model_path: str = None, blank_index: int = 0):
        self.vocab_list = list(vocab_list)
        self.alpha = alpha
        self.beta = beta
        self.beam_size = beam_size
        self.num_processes = max(1, num_processes)
        self.cutoff_prob = cutoff_prob
        self.cutoff_top_n = cutoff_top_n
        self.blank_index = blank_index
        self.scorer = None
        if language_model_path:
            import os
            if os.path.exists(language_model_path):
                from ppasr_tpu_torch.decoders.lm import load_scorer
                self.scorer = load_scorer(language_model_path,
                                          self.vocab_list)
            else:
                import logging
                logging.getLogger(__name__).warning(
                    f"LM not found: {language_model_path}; decoding LM-free")
        self.reset()

    def _to_text(self, prefix):
        return ''.join(self.vocab_list[i] for i in prefix)

    def decode(self, probs: np.ndarray):
        """[T, V] probs → (score, text)."""
        results = ctc_prefix_beam_search(
            np.asarray(probs), self.beam_size, self.blank_index,
            self.cutoff_prob, self.cutoff_top_n, self.scorer,
            self.alpha, self.beta)
        if not results:
            return 0.0, ''
        score, prefix = results[0]
        return score, self._to_text(prefix)

    def decode_batch(self, probs_batch, lens):
        """Batch offline decode with a thread pool (the C++ decoder uses an
        utterance-parallel threadpool)."""
        probs_list = [np.asarray(p)[:int(l)]
                      for p, l in zip(probs_batch, lens)]
        with ThreadPoolExecutor(max_workers=self.num_processes) as pool:
            return list(pool.map(self.decode, probs_list))

    # ------------------------------------------------------------ streaming

    def reset(self):
        self._beams = {(): (0.0, LOG0)}

    def decode_chunk(self, chunk_probs: np.ndarray):
        """Feed new frames (incremental beam update); returns (score, text)
        of the best hypothesis over everything so far."""
        probs = np.asarray(chunk_probs)
        for t in range(probs.shape[0]):
            self._beams = _beam_step(self._beams, probs[t], self.blank_index,
                                     self.cutoff_prob, self.cutoff_top_n,
                                     self.beam_size, self.scorer,
                                     self.alpha, self.beta)
        return self.current()

    def current(self):
        best_prefix, best_score = (), LOG0
        for prefix, v in self._beams.items():
            s = _logsumexp(*v)
            if s > best_score:
                best_score, best_prefix = s, prefix
        if best_score == LOG0:
            return 0.0, ''
        return best_score, self._to_text(best_prefix)
