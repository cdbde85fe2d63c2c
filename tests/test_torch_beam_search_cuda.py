"""The on-device beam search (ppasr_tpu_torch/decoders/beam_search_torch.py)
on the card against the same decoder on the CPU, at the flagship's width:
beam 300, 40 candidates, the 425-token vocabulary and the order-3 hash LM of
lm/synth_lm.arpa. The CPU side is pinned to the JAX package by
tests/test_torch_beam_search.py. These tests skip without a card; the file
imports no JAX, so it runs on a machine with only the port's packages:

    python -m pytest --noconftest -m gpu tests/test_torch_beam_search_cuda.py

Tolerances: hashes, token ids, prefixes, lengths and texts exact (the hashes
bit for bit, also against the host fold of decoders/lm.py); log-probs and
scores within 1e-4 absolute plus 1e-5 relative. After a whole decode at
full width, two beams whose totals lie within that tolerance may stand in
either order, and one such beam at the K-th place may differ
(``assert_beams_match``); one step is compared field by field."""
import os
import sys

import numpy as np
import pytest
import torch

from ppasr_tpu_torch.decoders import beam_search_torch as T
from ppasr_tpu_torch.decoders import lm as port_lm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402

ATOL, RTOL = 1e-4, 1e-5
FLAGSHIP = dict(beam_size=300, cutoff_top_n=40, cutoff_prob=0.99, alpha=0.8,
                beta=1.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the on-device beam search is checked here on a card; "
                    "its CPU path is tested against JAX elsewhere")
    return torch.device('cuda:0')


@pytest.fixture(scope='module')
def synth():
    vocab = fx.vocabulary()
    scorer = port_lm.NgramScorer(os.path.join(fx.ROOT, fx.BEAM_LM), vocab)
    return vocab, scorer, port_lm.build_hash_tables(scorer, vocab)


def _probs(seed, b, t, v):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, t, v)) * 2.5).astype(np.float32)
    logits[:, ::3, 0] += 8.0
    for i in range(b):
        for j in range(t):
            logits[i, j, rng.integers(1, v, 2)] += 6.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32), logits


def _assert_states_equal(got, want):
    for name in ('prefixes', 'lengths', 'last', 'hashes'):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    for name in ('p_b', 'p_nb'):
        g, w = getattr(got, name).cpu(), getattr(want, name)
        assert torch.equal(g <= T.NEG_INF / 2, w <= T.NEG_INF / 2), name
        live = w > T.NEG_INF / 2
        np.testing.assert_allclose(g[live].numpy(), w[live].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def assert_beams_match(got, want):
    """Row by row: the totals ranked best first agree within the tolerance
    at every rank; a beam (by hash) present on both sides has the same
    tokens, length, last token and log-probs; a beam on one side only has a
    total within the tolerance of the K-th, where float rounding decides
    who stays."""
    got = T.BeamState(*(x.cpu() for x in got))
    for b in range(want.p_b.shape[0]):
        tw = T._logaddexp(want.p_b[b], want.p_nb[b])
        tg = T._logaddexp(got.p_b[b], got.p_nb[b])
        np.testing.assert_allclose(tg.numpy(), tw.numpy(), rtol=RTOL,
                                   atol=ATOL)
        hw = {int(h): k for k, h in enumerate(want.hashes[b]) if tw[k] > -1e29}
        hg = {int(h): k for k, h in enumerate(got.hashes[b]) if tg[k] > -1e29}
        for h in hw.keys() & hg.keys():
            i, j = hw[h], hg[h]
            n = int(want.lengths[b, i])
            assert int(got.lengths[b, j]) == n
            assert int(got.last[b, j]) == int(want.last[b, i])
            assert torch.equal(got.prefixes[b, j, :n], want.prefixes[b, i, :n])
            for name in ('p_b', 'p_nb'):
                g = float(getattr(got, name)[b, j])
                w = float(getattr(want, name)[b, i])
                assert (g <= -1e29) == (w <= -1e29), name
                if w > -1e29:
                    assert abs(g - w) <= ATOL + RTOL * abs(w), name
        kth = float(tw[-1])
        for h, k, tot in [(h, k, tw) for h, k in hw.items() if h not in hg] \
                + [(h, k, tg) for h, k in hg.items() if h not in hw]:
            assert abs(float(tot[k]) - kth) <= 2 * (ATOL + RTOL * abs(kth)), \
                (b, k, float(tot[k]), kth)


@pytest.mark.gpu
def test_hashes_bit_for_bit_on_card():
    dev = _card()
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2 ** 32, 8192, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 0xFFFFFFFE, 0xFFFFFFFF]
    got = T._fmix32_dev(torch.from_numpy(h.astype(np.int64)).to(dev))
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  port_lm._fmix32_np(h).astype(np.int64))
    toks = [rng.integers(-1, 426, 500) for _ in range(3)]
    h1, h2 = T._hash_fold([torch.from_numpy(t).to(dev) for t in toks])
    host = [port_lm._fold_hash([int(t[i]) for t in toks]) for i in range(500)]
    np.testing.assert_array_equal(h1.cpu().numpy(), [a for a, _ in host])
    np.testing.assert_array_equal(h2.cpu().numpy(), [b for _, b in host])
    hashes = torch.from_numpy(h[:300].astype(np.int64))
    cand = torch.from_numpy(rng.integers(0, 425, 40))
    ext = T._mul32(hashes[:, None], T.HASH_PRIME) + cand + 1 & T.MASK32
    ext_dev = T._mul32(hashes.to(dev)[:, None], T.HASH_PRIME) \
        + cand.to(dev) + 1 & T.MASK32
    assert torch.equal(ext_dev.cpu(), ext)
    want = (h[:300, None].astype(np.uint64) * 1000003
            + cand.numpy().astype(np.uint64) + 1) % (1 << 32)
    np.testing.assert_array_equal(ext.numpy(), want.astype(np.int64))


@pytest.mark.gpu
def test_hash_lm_score_on_card(synth):
    dev = _card()
    vocab, scorer, tables = synth
    rng = np.random.default_rng(1)
    ctx = rng.integers(-1, len(vocab), (4, 300, 2))
    ctx[:, :, 1] = np.where(ctx[:, :, 0] < 0, -1, ctx[:, :, 1])
    cand = rng.integers(1, len(vocab), (4, 40))
    want = T._hash_lm_score(T.hash_lm_from_tables(tables),
                            torch.from_numpy(ctx), torch.from_numpy(cand))
    lm = T.hash_lm_from_tables(tables, dev)
    assert all(t.is_cuda for t in lm.tensors())
    got = T._hash_lm_score(lm, torch.from_numpy(ctx).to(dev),
                           torch.from_numpy(cand).to(dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    for i in range(0, 300, 37):
        prefix = [int(x) for x in ctx[0, i, ::-1] if x >= 0]
        np.testing.assert_allclose(
            got[0, i].cpu().numpy(),
            [scorer.score(prefix, int(c)) for c in cand[0]], rtol=RTOL,
            atol=ATOL)


@pytest.mark.gpu
def test_candidates_tie_order_on_card():
    """torch.topk promises no order among equal values; the stable sort
    keeps the lower index first on the card as on the CPU."""
    dev = _card()
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 4, (8, 50, 425)).astype(np.float32)
    counts[:, :, 0] += 40
    probs = torch.from_numpy(counts / counts.sum(-1, keepdims=True))
    want = T.precompute_candidates(probs, 0, 40, 0.99)
    got = T.precompute_candidates(probs.to(dev), 0, 40, 0.99)
    assert torch.equal(got[1].cpu(), want[1])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize('merge_mode', ['match', 'sort', 'scatter'])
def test_one_step_on_card(synth, merge_mode):
    dev = _card()
    vocab, _, tables = synth
    probs, _ = _probs(3, 3, 3, len(vocab))
    kw = dict(beam_size=300, cutoff_top_n=40, cutoff_prob=0.99, alpha=0.8,
              beta=1.0, max_prefix_len=16, merge_mode=merge_mode)
    lm_cpu = T.hash_lm_from_tables(tables)
    lm_dev = T.hash_lm_from_tables(tables, dev)
    lens = torch.tensor([2, 2, 2])
    state = T.ctc_beam_search(torch.from_numpy(probs[:, :2]), lens,
                              lm_hash=lm_cpu, **kw)
    active = torch.tensor([True, False, True])
    step = dict(blank=0, **{k: kw[k] for k in ('beam_size', 'cutoff_top_n',
                                                'cutoff_prob', 'alpha',
                                                'beta', 'merge_mode')})
    want = T.beam_search_step_batch(state, torch.from_numpy(probs[:, 2]),
                                    active, lm_hash=lm_cpu, **step)
    got = T.beam_search_step_batch(
        T.BeamState(*(x.to(dev) for x in state)),
        torch.from_numpy(probs[:, 2]).to(dev), active.to(dev),
        lm_hash=lm_dev, **step)
    assert got.hashes.is_cuda
    _assert_states_equal(got, want)


@pytest.mark.gpu
def test_full_width_decoder_on_card(synth):
    """The decoder at the flagship conf on cuda:0 against the same decoder
    on the CPU: the final states of the probs and logits paths, the texts
    and the streaming chunks."""
    dev = _card()
    vocab, _, tables = synth
    probs, logits = _probs(4, 4, 60, len(vocab))
    lens = np.array([60, 47, 55, 31])
    cpu = T.TorchBeamSearchDecoder(vocab, device='cpu', **FLAGSHIP)
    card = T.TorchBeamSearchDecoder(vocab, device=dev, **FLAGSHIP)
    cpu.lm_hash = T.hash_lm_from_tables(tables)
    card.lm_hash = T.hash_lm_from_tables(tables, dev)
    want = cpu.decode_batch_states(probs, lens)
    got = card.decode_batch_states(torch.from_numpy(probs).to(dev), lens)
    assert all(t.is_cuda for t in got)
    assert_beams_match(got, want)
    assert_beams_match(
        card.decode_batch_states_from_logits(torch.from_numpy(logits).to(dev),
                                             torch.from_numpy(lens).to(dev)),
        cpu.decode_batch_states_from_logits(logits, lens))
    rw, rg = cpu.decode_batch(probs, lens), card.decode_batch(probs, lens)
    assert [t for _, t in rg] == [t for _, t in rw]
    np.testing.assert_allclose([s for s, _ in rg], [s for s, _ in rw],
                               rtol=RTOL, atol=ATOL)
    for chunk in np.split(probs[0], [16, 33]):
        g, w = card.decode_chunk(chunk), cpu.decode_chunk(chunk)
        assert g[1] == w[1]
        np.testing.assert_allclose(g[0], w[0], rtol=RTOL, atol=ATOL)
    assert all(t.is_cuda for t in card.tensors())


@pytest.mark.gpu
def test_wide_beam_large_batch_prefix_writes_on_card():
    dev = _card()
    rng = np.random.default_rng(11)
    bsz, t_max, vocab_n = 32, 10, 60
    vocab = ['<blank>'] + [chr(ord('a') + i % 26) + str(i // 26)
                           for i in range(vocab_n - 1)]
    logits = rng.standard_normal((bsz, t_max, vocab_n)).astype(np.float32)
    answers = []
    for b in range(bsz):
        toks = 1 + (rng.permutation(vocab_n - 1)[:3])
        answers.append(''.join(vocab[t] for t in toks))
        for j, t in enumerate(toks):
            logits[b, 2 * j, t] += 14.0
            logits[b, 2 * j + 1, 0] += 14.0
        logits[b, 6:, 0] += 14.0
    dec = T.TorchBeamSearchDecoder(vocab, beam_size=300, device=dev)
    res = dec.decode_batch_from_logits(torch.from_numpy(logits).to(dev),
                                       np.full((bsz,), t_max))
    assert [h for _, h in res] == answers
