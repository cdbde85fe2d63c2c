"""Error-rate metrics, CER and WER (counterpart of
ppasr_tpu/utils/metrics.py:12-33). The JAX package takes the edit distance
from the ``Levenshtein`` package; the port computes it in plain Python
(``edit_distance``), with the same unit costs."""


def edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences: insertions, deletions and
    substitutions each cost 1."""
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (ca != cb))
    return row[-1]


def cer(hypothesis: str, reference: str) -> float:
    """Character error rate; spaces are ignored."""
    hypothesis = hypothesis.replace(" ", "")
    reference = reference.replace(" ", "")
    if len(reference) == 0:
        return 0.0 if len(hypothesis) == 0 else 1.0
    return edit_distance(hypothesis, reference) / len(reference)


def wer(hypothesis: str, reference: str) -> float:
    """Word error rate: each distinct word is mapped to one character and
    the character-level distance is taken."""
    hyp_words = hypothesis.split()
    ref_words = reference.split()
    if len(ref_words) == 0:
        return 0.0 if len(hyp_words) == 0 else 1.0
    vocab = {}
    for w in ref_words + hyp_words:
        if w not in vocab:
            vocab[w] = chr(len(vocab))
    hyp_str = "".join(vocab[w] for w in hyp_words)
    ref_str = "".join(vocab[w] for w in ref_words)
    return edit_distance(hyp_str, ref_str) / len(ref_words)
