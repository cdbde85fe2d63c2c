"""The traffic generator: one seed, one set of inputs; the lengths, piece
rate, pauses and levels each mix names; every seed the same set of sizes
in another order."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import traffic

TRAFFIC = Path(__file__).resolve().parents[1] / 'traffic'


def mix(name):
    return json.loads((TRAFFIC / f'{name}.json').read_text())


def test_quantiles_of_the_length_distribution():
    spec = mix('stream_rt')['length_s']
    q = traffic.quantiles(spec, 1001)
    assert q[500] == pytest.approx(4.5)
    assert q.min() >= 0.5 and q.max() <= 20.0
    assert np.all(np.diff(q) >= 0)
    # the share under e^σ·median is Φ(1)
    assert np.mean(q < 4.5 * np.exp(0.45)) == pytest.approx(0.8413, abs=2e-3)


def test_stream_schedule_is_seeded_and_paced():
    m = mix('stream_rt')
    a = traffic.stream_schedule(m, 2 ** 31 + 77, 20.0)
    b = traffic.stream_schedule(m, 2 ** 31 + 77, 20.0)
    c = traffic.stream_schedule(m, 5, 20.0)
    assert a[1] == b[1] and a[1] != c[1]
    utts, pieces, piece = a
    assert piece == 2560
    assert all(0 <= due < 20.0 for due, *_ in pieces)
    assert [p[0] for p in pieces] == sorted(p[0] for p in pieces)
    # every speaker sends one piece per 0.16 s while it talks
    for u in utts[:10]:
        dues = [due for due, uid, _, _ in pieces if uid == u.uid]
        if len(dues) > 2:
            assert np.allclose(np.diff(dues)[:-1], 0.16)
        ends = [end for _, uid, _, end in pieces if uid == u.uid]
        assert sum(ends) <= 1
    # pauses between a speaker's utterances as drawn, in [0, 1] s after
    # the last sample
    by_spk = {}
    for u in utts:
        by_spk.setdefault(u.speaker, []).append(u)
    assert len(by_spk) == m['streams']
    pauses = []
    for us in by_spk.values():
        for x, y in zip(us, us[1:]):
            pause = y.start - (x.start + x.n_samples / traffic.RATE)
            assert -1e-9 <= pause <= 1.0 + 1e-9
            pauses.append(pause)
        lens = [u.n_samples / traffic.RATE for u in us[1:]]
        assert all(0.5 <= n <= 20.0 for n in lens)
    # not rounded to whole pieces: speakers drift against one another
    assert any(abs(x / 0.16 - round(x / 0.16)) > 0.01 for x in pauses)
    # the first starts spread over one window period (4 pieces), apart
    starts = sorted(us[0].start for us in by_spk.values())
    assert max(starts) < 0.64 and len(set(starts)) == m['streams']


def test_every_seed_gets_the_same_lengths():
    m = mix('offline_b64')
    a, b = traffic.offline_pool(m, 1), traffic.offline_pool(m, 2 ** 33)
    assert a == traffic.offline_pool(m, 1) and a != b
    flat = lambda p: sorted(n for batch in p for n, _ in batch)  # noqa
    assert flat(a) == flat(b)
    # the longest of each batch is one of the pool's pool_batches longest
    maxima = lambda p: sorted(max(n for n, _ in batch) for batch in p)  # noqa
    assert maxima(a) == maxima(b) == flat(a)[-m['pool_batches']:]
    assert len(a) == m['pool_batches'] and all(len(x) == 64 for x in a)
    # unsorted within a batch
    assert any(np.any(np.diff([n for n, _ in batch]) < 0) for batch in a)


def test_audio_is_seeded_at_its_level():
    lens, levels = [16000, 32000], [-20.0, -30.0]
    a = traffic.synth_audio(lens, levels, 3, 'cpu')
    b = traffic.synth_audio(lens, levels, 3, 'cpu')
    c = traffic.synth_audio(lens, levels, 4, 'cpu')
    assert [len(x) for x in a] == lens and all(x.dtype == np.int16 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    for x, level in zip(a, levels):
        rms = np.sqrt(np.mean((x / 32768.0) ** 2))
        assert 20 * np.log10(rms) == pytest.approx(level, abs=0.05)
    assert torch.get_default_dtype() == torch.float32
