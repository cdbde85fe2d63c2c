"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes, from ``--seed``, the inputs the program
is given (int16 PCM, arrival times).

Sizes come from fixed quantiles of each distribution, ``(i + ½) / n``, so
every seed gets the same set of lengths, pauses and levels in another
order, and the work in a window does not change with the seed.

- ``stream``: ``streams`` independent speakers in an open loop. Each
  sends its utterance as pieces of ``piece_s`` of PCM, a piece due when its
  audio has been spoken, the last one flagged as the end; a new utterance
  follows after a pause as drawn. Speaker k opens at a uniform offset
  within the engine's window period (``decoding_chunk_size`` × 4 frames of
  10 ms), with what is left of an utterance under way (a uniform share of
  it), so the window starts in the steady state. Nothing aligns one
  speaker's pieces or windows with another's: ticks collide and queue as
  they fall.
- ``offline``: a closed loop over a pool of ``pool_batches`` batches of
  ``batch`` utterances, unsorted. The pool's lengths are stratified over
  the batches (each batch draws one length from each of ``batch`` strata),
  so each batch's longest utterance, and so its padding, is the same for
  every seed.

Audio: a voiced tone of three harmonics of a per-utterance pitch under a
syllable-rate envelope, plus noise, at a per-utterance RMS level in dBFS.
It is made on the device in one draw for the whole run.
"""
import math
import statistics

import numpy as np
import torch

from harness.weights import sub_seed

RATE = 16000


def quantiles(spec: dict, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    if spec['dist'] == 'lognormal':
        z = np.array([statistics.NormalDist().inv_cdf(float(p)) for p in q])
        v = spec['median'] * np.exp(spec['sigma'] * z)
    elif spec['dist'] == 'uniform':
        v = spec['min'] + (spec['max'] - spec['min']) * q
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return np.clip(v, spec.get('min', -np.inf), spec.get('max', np.inf))


def synth_audio(n_samples, levels_db, seed: int, device) -> list:
    """int16 PCM of each length at its level, made in one device draw."""
    n_samples = np.asarray(n_samples, np.int64)
    n_utt = len(n_samples)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 2))
    lens = torch.from_numpy(n_samples).to(device)
    utt = torch.repeat_interleave(torch.arange(n_utt, device=device), lens)
    starts = torch.cumsum(lens, 0) - lens
    t = (torch.arange(int(lens.sum()), device=device) - starts[utt]) / RATE
    u = torch.rand(4, n_utt, generator=g, device=device)
    f0, syl = 100.0 + 120.0 * u[0], 3.0 + 2.0 * u[1]
    ph1, ph2 = 2 * math.pi * u[2], 2 * math.pi * u[3]
    w = 2 * math.pi * f0[utt] * t
    voiced = torch.sin(w) + 0.5 * torch.sin(2 * w + ph2[utt]) \
        + 0.25 * torch.sin(3 * w)
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * syl[utt] * t + ph1[utt])
    sig = env * env * voiced + 0.3 * torch.randn(
        t.shape, generator=g, device=device)
    power = torch.zeros(n_utt, device=device).index_add_(0, utt, sig * sig)
    target = 32768.0 * 10.0 ** (torch.as_tensor(
        np.asarray(levels_db, np.float32), device=device) / 20.0)
    sig = sig * (target / torch.sqrt(power / lens))[utt]
    pcm = sig.round().clamp(-32767, 32767).to(torch.int16).cpu().numpy()
    return np.split(pcm, np.cumsum(n_samples)[:-1])


class Utterance:
    def __init__(self, uid, speaker, start, n_samples, level):
        self.uid, self.speaker, self.start = uid, speaker, start
        self.n_samples, self.level = n_samples, level
        self.pcm = None

    def piece_bounds(self, piece: int):
        return [(a, min(a + piece, self.n_samples))
                for a in range(0, self.n_samples, piece)]


def stream_schedule(traffic: dict, seed: int, seconds: float):
    """(utterances, pieces, piece samples): every utterance that starts in
    the window, and every piece due in the window as (due_s, uid, index,
    is_end), in due order."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    n_spk, pool = int(traffic['streams']), int(traffic['pool'])
    piece = int(round(float(traffic['piece_s']) * RATE))
    period = int(traffic['decoding_chunk_size']) * 4 * 0.01
    lengths = rng.permutation(quantiles(traffic['length_s'], pool))
    pauses = rng.permutation(quantiles(traffic['pause_s'], pool))
    levels = rng.permutation(quantiles(traffic['level_dbfs'], pool))
    unit = {'dist': 'uniform', 'min': 0.0, 'max': 1.0}
    left = rng.permutation(quantiles(unit, n_spk))
    offsets = rng.permutation(quantiles(unit, n_spk)) * period
    utts, pieces = [], []
    for k in range(n_spk):
        t, j = float(offsets[k]), k
        while t < seconds:
            n = int(round(lengths[j % pool] * RATE))
            if j == k:
                n = max(piece, int(math.ceil(left[k] * n)))
            u = Utterance(len(utts), k, t, n, levels[j % pool])
            utts.append(u)
            for i, (_, b) in enumerate(u.piece_bounds(piece)):
                due = t + b / RATE
                if due < seconds:
                    pieces.append((due, u.uid, i, b == n))
            t += n / RATE + float(pauses[j % pool])
            j += n_spk
    pieces.sort()
    return utts, pieces, piece


def offline_pool(traffic: dict, seed: int):
    """[pool_batches][batch] (n_samples, level_db), unsorted within a
    batch, lengths stratified over the batches."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    bsz, n_b = int(traffic['batch']), int(traffic['pool_batches'])
    lengths = quantiles(traffic['length_s'], bsz * n_b).reshape(bsz, n_b)
    levels = rng.permutation(quantiles(traffic['level_dbfs'], bsz * n_b))
    strata = np.stack([rng.permutation(row) for row in lengths])
    batches = []
    for b in range(n_b):
        order = rng.permutation(bsz)
        batches.append([(int(round(strata[i, b] * RATE)),
                         float(levels[b * bsz + i])) for i in order])
    return batches
