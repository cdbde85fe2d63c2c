"""CTC loss cases shared by the CPU tests (tests/test_torch_ctc_loss.py),
the card tests (tests/test_torch_ctc_cuda.py) and chip_smoke.py; no JAX
here.

Every case of ``CASES`` is [3, 12, 7] logits with labels padded to 4, so
that JAX compiles each function once: labels (−1 padded), label lengths,
input lengths."""
import numpy as np
import torch

from ppasr_tpu_torch.ops import ctc

P = -1
CASES = {
    'mixed': ([[1, 2, 2, 3], [4, P, P, P], [5, 6, 5, 1]], [4, 1, 4],
              [12, 9, 9]),
    'empty-label': ([[3, 1, P, P], [P, P, P, P], [2, P, P, P]], [2, 0, 1],
                    [10, 7, 1]),
    'repeat-at-2U+1': ([[2, 2, 2, P], [1, 2, 3, P], [3, 3, P, P]],
                       [3, 3, 2], [7, 7, 5]),
    'tight-no-repeat': ([[1, 2, 3, P], [4, 5, P, P], [6, P, P, P]],
                        [3, 2, 1], [3, 2, 1]),
}
# rows whose labels do not fit their frames (4 labels in 3 frames, a
# repeat needing 3 frames in 2), beside one that fits and one of input
# length 0: every path of the first two is LOG_EPSILON
UNFIT = ([[1, 2, 3, 4], [5, 5, P, P], [2, 3, P, P], [6, P, P, P]],
         [4, 2, 2, 1], [3, 2, 12, 0])
T, V = 12, 7


def inputs(case, seed=0):
    """(logits [B, T, V] float32, labels int32, label lengths, input
    lengths) of a named case (or ``'unfit'``) from ``seed``."""
    labels, ll, il = (np.asarray(a) for a in (UNFIT if case == 'unfit'
                                              else CASES[case]))
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((len(ll), T, V)).astype(np.float32) * 2
    return logits, labels.astype(np.int32), ll, il


def cell_batch(max_t, seed, rows=16, max_u=51, vocab=4233):
    """The training cell's micro-step at one padded length, as ``inputs``:
    [16, T', 4,233] logits, mixed input lengths (row 0 all T' frames),
    up to 51 labels (row 0 all 51) uniform over the vocabulary less
    blank."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((rows, max_t, vocab)).astype(np.float32) * 3
    il = rng.integers(max_t // 2, max_t + 1, rows)
    il[0] = max_t
    ll = rng.integers(0, max_u + 1, rows)
    ll[0] = max_u
    labels = rng.integers(1, vocab, (rows, max_u)).astype(np.int32)
    labels[np.arange(max_u)[None, :] >= ll[:, None]] = -1
    return logits, labels, ll, il


def loss_and_grad(logits, il, labels, ll, plain=False, average_batch=True,
                  weights=None):
    """(loss, gradient of the logits) of ``ctc_loss_from_logits``, through
    kernel C1 on a CUDA tensor or, with ``plain``, through the plain
    ``ctc.lattice_alpha`` and autograd on the same device. With
    ``average_batch`` False the backward takes Σ weights · nll, so the
    kernel reads a gradient of stride 1."""
    x = logits.detach().requires_grad_()
    if plain:
        ext, valid, skip = ctc._extended_labels(labels, ll, 0)
        emit = ctc.EmissionsFromLogits.apply(x, ext)
        loss = ctc.lattice_alpha(emit, il, ll, valid, skip)
        if average_batch:
            loss = loss.sum() / loss.shape[0]
    else:
        loss = ctc.ctc_loss_from_logits(x, il, labels, ll,
                                        average_batch=average_batch)
    (loss if average_batch else (loss * weights).sum()).backward()
    return loss.detach(), x.grad
