"""CTC greedy decoding (counterpart of ppasr_tpu/decoders/greedy.py:18-97):
argmax → collapse repeats → drop blanks; score = mean of the kept frames'
max-probs × 100. ``ctc_argmax`` reduces on the tensor's device, so
``greedy_decoder_batch`` moves only the [B, T] id and score planes to the
host; the collapse to text is host code. ``GreedyStreamingDecoder`` keeps
the argmax history across chunks."""
import numpy as np
import torch


def ctc_argmax(probs: torch.Tensor):
    """[B, T, V] probs → ([B, T] argmax ids, [B, T] max probs) on the
    tensor's device. ``torch.argmax`` returns the first maximal index, as
    numpy and JAX do."""
    return torch.argmax(probs, dim=-1), torch.amax(probs, dim=-1)


def _collapse(ids: np.ndarray, max_probs: np.ndarray, vocabulary,
              blank_index: int = 0):
    """Collapse repeats → drop blanks → map to text + confidence score."""
    prev = -1
    tokens, scores = [], []
    for t, idx in enumerate(ids):
        idx = int(idx)
        if idx != prev:
            prev = idx
            if idx != blank_index:
                tokens.append(idx)
                scores.append(float(max_probs[t]))
    score = float(np.mean(scores) * 100) if scores else 0.0
    text = ''.join(vocabulary[i] for i in tokens)
    return score, text


def greedy_decoder(probs, vocabulary, blank_index: int = 0):
    """[T, V] probs → (score, text)."""
    probs = np.asarray(probs)
    return _collapse(probs.argmax(axis=-1), probs.max(axis=-1), vocabulary,
                     blank_index)


def greedy_decoder_batch(probs_batch: torch.Tensor, lens, vocabulary,
                         blank_index: int = 0):
    """[B, T, V] padded probs + [B] lens → list of (score, text). The
    argmax and max run on the tensor's device (``ctc_argmax``)."""
    ids, max_probs = ctc_argmax(probs_batch)
    ids_b, maxp_b = ids.cpu().numpy(), max_probs.cpu().numpy()
    out = []
    for b in range(ids_b.shape[0]):
        t = int(lens[b])
        out.append(_collapse(ids_b[b, :t], maxp_b[b, :t], vocabulary,
                             blank_index))
    return out


class GreedyStreamingDecoder:
    """Accumulates per-chunk argmax history."""

    def __init__(self, vocabulary, blank_index: int = 0):
        self.vocabulary = vocabulary
        self.blank_index = blank_index
        self.reset()

    def reset(self):
        self._ids = []
        self._probs = []

    def decode_chunk(self, chunk_probs):
        """chunk_probs [T_chunk, V] → (score, text) of the whole utterance
        so far."""
        probs = np.asarray(chunk_probs)
        if probs.size:
            self._ids.extend(probs.argmax(axis=-1).tolist())
            self._probs.extend(probs.max(axis=-1).tolist())
        return self.current()

    def current(self):
        """(score, text) for everything decoded so far."""
        if not self._ids:
            return 0.0, ''
        return _collapse(np.asarray(self._ids), np.asarray(self._probs),
                         self.vocabulary, self.blank_index)
