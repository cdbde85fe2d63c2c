"""Port parity of the on-device CTC prefix beam search:
``ppasr_tpu_torch/decoders/beam_search_torch.py`` against the JAX package's
``beam_search_jax.py`` on the CPU, the same numpy inputs (made from a seed)
through both.

Tolerances: token ids, lengths, hashes, prefixes and texts exact; log-probs
and scores within 1e-4 absolute plus 1e-5 relative (``ATOL``, ``RTOL``).
Compacted arrays are compared where the scan reads them (below each row's
length); the slots past it hold no result. One step is compared field by
field; after a whole decode at full width, beams whose totals lie within
the tolerance may stand in either order (``assert_beams_match``, shared
with the card tests)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppasr_tpu.decoders import beam_search_jax as J
from ppasr_tpu.decoders.lm import NgramScorer as JaxScorer
from ppasr_tpu.decoders.lm import build_hash_tables as jax_tables
from ppasr_tpu_torch.decoders import beam_search_torch as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402
from test_torch_beam_search_cuda import assert_beams_match  # noqa: E402
from torch_tiny_artifact import random_arpa  # noqa: E402

ATOL, RTOL = 1e-4, 1e-5
VOCAB = ['<blank>'] + [chr(ord('a') + i) for i in range(25)]
V = len(VOCAB)
SYNTH_LM = os.path.join(fx.ROOT, fx.BEAM_LM)
FLAGSHIP = dict(beam_size=300, cutoff_top_n=40, cutoff_prob=0.99, alpha=0.8,
                beta=1.0)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_state_equal(got: T.BeamState, want: J.BeamState):
    """Prefixes, lengths, last and hashes exact; p_b and p_nb within the
    tolerance, NEG_INF (dead) entries exactly where JAX has them."""
    for name in ('prefixes', 'lengths', 'last', 'hashes'):
        np.testing.assert_array_equal(
            _np(getattr(got, name)).astype(np.int64),
            _np(getattr(want, name)).astype(np.int64), err_msg=name)
    for name in ('p_b', 'p_nb'):
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        np.testing.assert_array_equal(g <= T.NEG_INF / 2, w <= J.NEG_INF / 2,
                                      err_msg=name)
        live = w > J.NEG_INF / 2
        _close(g[live], w[live])


def to_port(state: J.BeamState) -> T.BeamState:
    a = [np.asarray(x) for x in state]
    return T.BeamState(
        prefixes=torch.from_numpy(a[0].astype(np.int32)),
        lengths=torch.from_numpy(a[1].astype(np.int64)),
        last=torch.from_numpy(a[2].astype(np.int64)),
        hashes=torch.from_numpy(a[3].astype(np.int64)),
        p_b=torch.from_numpy(a[4].copy()), p_nb=torch.from_numpy(a[5].copy()))


def peaky_probs(rng, b, t, v, blank_every=3, spike=6.0):
    """[B, T, V] float32 posteriors of a CTC-like shape: a few tokens stand
    out in each frame, and every ``blank_every``-th frame is blank."""
    logits = (rng.standard_normal((b, t, v)) * 2.5).astype(np.float32)
    logits[:, ::blank_every, 0] += 8.0
    for i in range(b):
        for j in range(t):
            logits[i, j, rng.integers(1, v, 2)] += spike
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32), logits


# one jitted JAX step; top_n, beam_size, alpha, beta and merge_mode static
_jax_step = jax.jit(J._masked_step, static_argnums=(5, 6, 9, 10, 11))


@pytest.fixture(scope='module')
def synth_tables():
    vocab = fx.vocabulary()
    return vocab, jax_tables(JaxScorer(SYNTH_LM, vocab), vocab)


# --------------------------------------------------------------- phase 1

def test_precompute_candidates_tie_order():
    """Small-integer probabilities tie often; the port's top-N must list the
    lower token first among equal values, as jax.lax.top_k does."""
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 4, (2, 7, 30)).astype(np.float32)
    counts[:, :, 0] += 3
    probs = counts / counts.sum(-1, keepdims=True)
    for top_n, cutoff in ((12, 0.99), (30, 1.0)):
        got = T.precompute_candidates(torch.from_numpy(probs), 0, top_n,
                                      cutoff)
        want = J.precompute_candidates(jnp.asarray(probs), 0, top_n, cutoff)
        _close(got[0], want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[2], want[2])
    exact = T.precompute_candidates(torch.from_numpy(probs), 0, 12, 0.99)
    approx = T.precompute_candidates(torch.from_numpy(probs), 0, 12, 0.99,
                                     'approx')
    assert all(torch.equal(a, b) for a, b in zip(approx, exact))


def test_candidates_from_logits_tie_order():
    rng = np.random.default_rng(1)
    logits = rng.integers(-3, 3, (3, 9, 26)).astype(np.float32)
    lse = torch.logsumexp(torch.from_numpy(logits), -1)
    got = T.candidates_from_logits(torch.from_numpy(logits), lse, 0, 10,
                                   0.99)
    want = J.candidates_from_logits(jnp.asarray(logits),
                                    jax.nn.logsumexp(jnp.asarray(logits), -1),
                                    0, 10, 0.99)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])


def _compaction_case():
    rng = np.random.default_rng(2)
    probs, _ = peaky_probs(rng, 4, 30, V, blank_every=2, spike=4.0)
    probs[1] = 0.0
    probs[1, :, 0] = 1.0                     # all blank
    probs[2, 3:, :] = probs[2, 3:, :] * 0.01  # a mostly blank tail
    probs[2, 3:, 0] += 0.99
    return probs, np.array([30, 30, 25, 30])


def test_compact_candidate_frames_matches_jax():
    probs, lens = _compaction_case()
    cj = J.precompute_candidates(jnp.asarray(probs), 0, 10, 0.99)
    cp = T.precompute_candidates(torch.from_numpy(probs), 0, 10, 0.99)
    want = J.compact_candidate_frames(*cj, jnp.asarray(lens), 0.9)
    got = T.compact_candidate_frames(*cp, torch.from_numpy(lens), 0.9)
    n = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), n)
    assert n[1] == 1 and n[0] > 5
    for b, k in enumerate(n):
        _close(got[0][b, :k], np.asarray(want[0])[b, :k])
        np.testing.assert_array_equal(got[1][b, :k], np.asarray(want[1])[b, :k])
        _close(got[2][b, :k], np.asarray(want[2])[b, :k])


def test_compact_blank_frames_matches_jax():
    probs, lens = _compaction_case()
    want, wl = J.compact_blank_frames(jnp.asarray(probs), jnp.asarray(lens),
                                      0, 0.9)
    got, gl = T.compact_blank_frames(torch.from_numpy(probs),
                                     torch.from_numpy(lens), 0, 0.9)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    for b, k in enumerate(np.asarray(wl)):
        np.testing.assert_array_equal(got[b, :k].numpy(),
                                      np.asarray(want)[b, :k])


def test_phase1_prepped_matches_jax():
    """keep_map + the host read + gather_topk (and their logits forms) give
    JAX's scan inputs where the scan reads them, and the same bucket."""
    probs, lens = _compaction_case()
    logits = np.log(np.maximum(probs, 1e-30))
    kw = dict(beam_size=4, cutoff_top_n=10, alpha=0, beta=0,
              blank_skip_threshold=0.9)
    dj = J.JaxBeamSearchDecoder(VOCAB, **kw)
    dp = T.TorchBeamSearchDecoder(VOCAB, device='cpu', **kw)
    for want, got in ((dj._prepped(probs, lens), dp._prepped(probs, lens)),
                      (dj._prepped_from_logits(jnp.asarray(logits), lens),
                       dp._prepped_from_logits(logits, lens))):
        n = np.asarray(want[3])
        np.testing.assert_array_equal(got[3].numpy(), n)
        assert got[0].shape == want[0].shape and got[4] == n.max()
        for b, k in enumerate(n):
            _close(got[0][b, :k], np.asarray(want[0])[b, :k])
            np.testing.assert_array_equal(got[1][b, :k].numpy(),
                                          np.asarray(want[1])[b, :k])
            _close(got[2][b, :k], np.asarray(want[2])[b, :k])


# --------------------------------------------------------------- phase 2

def _lm_args(kind, synth_tables, v, rng):
    """(JAX kwargs, port kwargs) of each LM form of the step."""
    if kind == 'none':
        return {}, {}
    if kind == 'bigram':
        uni = -rng.uniform(0.2, 4.0, v).astype(np.float32)
        big = -rng.uniform(0.1, 5.0, (v, v)).astype(np.float32)
        return (dict(lm_unigram=jnp.asarray(uni), lm_bigram=jnp.asarray(big)),
                dict(lm_unigram=torch.from_numpy(uni),
                     lm_bigram=torch.from_numpy(big)))
    vocab, tables = synth_tables
    assert len(vocab) == v
    return (dict(lm_hash=J.hash_lm_from_tables(tables)),
            dict(lm_hash=T.hash_lm_from_tables(tables)))


@pytest.fixture(scope='module')
def mid_state(synth_tables):
    """Three frames over the flagship vocabulary and JAX's beam-128 state
    after the first two (81 live prefixes, the rest dead)."""
    probs, _ = peaky_probs(np.random.default_rng(3), 3, 3,
                           len(synth_tables[0]), blank_every=4)
    state = J.ctc_beam_search_jax(jnp.asarray(probs[:, :2]),
                                  jnp.asarray([2, 2, 2]), beam_size=128,
                                  cutoff_top_n=8, cutoff_prob=0.99,
                                  max_prefix_len=8)
    dead = np.asarray(state.p_b) <= J.NEG_INF / 2
    dead &= np.asarray(state.p_nb) <= J.NEG_INF / 2
    assert 0 < dead.sum() < dead.size
    return probs, state


@pytest.mark.parametrize('lm_kind', ['none', 'bigram', 'trigram'])
@pytest.mark.parametrize('merge_mode', ['match', 'sort', 'scatter'])
def test_one_step_whole_state(synth_tables, mid_state, merge_mode, lm_kind):
    """One masked step from a mid-decode state with dead beams, over the
    flagship vocabulary: the whole new state equals JAX's, inactive rows
    untouched."""
    probs, state = mid_state
    v, k, n = len(synth_tables[0]), 128, 8
    j_lm, p_lm = _lm_args(lm_kind, synth_tables, v,
                          np.random.default_rng(4))
    active = np.array([True, False, True])
    cj = J.precompute_candidates(jnp.asarray(probs[:, 2]), 0, n, 0.99)
    cp = T.precompute_candidates(torch.from_numpy(probs[:, 2]), 0, n, 0.99)
    want = _jax_step(state, *cj, jnp.asarray(active), n, k,
                     j_lm.get('lm_bigram'), j_lm.get('lm_unigram'), 0.8, 1.0,
                     merge_mode, lm_hash=j_lm.get('lm_hash'))
    got = T._masked_step(to_port(state), *cp, torch.from_numpy(active),
                         n, k, p_lm.get('lm_bigram'),
                         p_lm.get('lm_unigram'), 0.8, 1.0, merge_mode,
                         lm_hash=p_lm.get('lm_hash'))
    assert_state_equal(got, want)
    assert_state_equal(T.BeamState(*(x[1] for x in got)),
                       J.BeamState(*(x[1] for x in state)))


def test_step_tie_lower_index_wins():
    """Seven extends tie (probability 0.1 each) for the two places left
    beside the stay: the lower candidate index, hence the lower token,
    takes them, in every merge mode, as in JAX."""
    probs = np.full((1, 8), 0.1, np.float32)
    probs[0, 0] = 0.3
    for mode in ('match', 'sort', 'scatter'):
        init_j = jax.vmap(lambda _: J.init_beam_state(3, 4))(jnp.arange(1))
        cj = J.precompute_candidates(jnp.asarray(probs), 0, 7, 1.0)
        want = _jax_step(init_j, *cj, jnp.asarray([True]), 7, 3, None,
                         None, 0.0, 0.0, mode)
        got = T.beam_search_step_batch(
            T.init_beam_state(3, 4), torch.from_numpy(probs),
            torch.tensor([True]), beam_size=3, cutoff_top_n=7,
            cutoff_prob=1.0, alpha=0.0, beta=0.0, merge_mode=mode)
        assert_state_equal(got, want)
        assert got.prefixes[0, :, 0].tolist() == [0, 1, 2]
        assert got.lengths[0].tolist() == [0, 1, 1]


def test_init_state_and_packing_match_jax():
    rng = np.random.default_rng(4)
    probs, _ = peaky_probs(rng, 3, 12, V)
    lens = np.array([12, 9, 12])
    want = J.ctc_beam_search_jax(jnp.asarray(probs), jnp.asarray(lens),
                                 beam_size=6, cutoff_top_n=8,
                                 max_prefix_len=16)
    got = T.ctc_beam_search(torch.from_numpy(probs), torch.from_numpy(lens),
                            beam_size=6, cutoff_top_n=8, max_prefix_len=16)
    assert_state_equal(got, want)
    assert_state_equal(T.init_beam_state(6, 16, 3), jax.vmap(
        lambda _: J.init_beam_state(6, 16))(jnp.arange(3)))
    pg, pw = T.pack_best_hypothesis(got), J.pack_best_hypothesis(want)
    np.testing.assert_array_equal(pg[:, 1:].numpy(), np.asarray(pw)[:, 1:])
    _close(pg[:, 0].view(torch.float32), np.asarray(pw)[:, 0].view(
        np.float32))
    assert [t for _, t in T.unpack_results(pg, VOCAB)] == \
        [t for _, t in J.unpack_results(pw, VOCAB)]
    for a, b in zip(T.all_hypotheses(got, 5), J.all_hypotheses(want, 5)):
        _close(a.float(), np.asarray(b, np.float32))
    best = np.array([2, 0, 5])
    scores = rng.standard_normal((3, 6)).astype(np.float32)
    a = T.pack_hypothesis_at(got, torch.from_numpy(best),
                             torch.from_numpy(scores))
    b = J.pack_hypothesis_at(want, jnp.asarray(best), jnp.asarray(scores))
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_full_width_batch_flagship_conf(synth_tables):
    """Beam 300, N 40, V 425, the order-3 hash LM of lm/synth_lm.arpa, three
    utterances of up to 60 frames, compaction on: best texts equal and
    scores within the tolerance, and the final beams matched."""
    vocab, tables = synth_tables
    rng = np.random.default_rng(5)
    probs, _ = peaky_probs(rng, 3, 60, len(vocab))
    lens = np.array([60, 47, 55])
    dj = J.JaxBeamSearchDecoder(vocab, **FLAGSHIP)
    dj.lm_hash = J.hash_lm_from_tables(tables)
    dp = T.TorchBeamSearchDecoder(vocab, device='cpu', **FLAGSHIP)
    dp.lm_hash = T.hash_lm_from_tables(tables)
    want = dj.decode_batch_states(probs, lens)
    got = dp.decode_batch_states(probs, lens)
    assert_beams_match(got, to_port(want))
    rj = J.beam_state_to_results(want, vocab)
    rp = T.beam_state_to_results(got, vocab)
    assert [t for _, t in rp] == [t for _, t in rj]
    assert all(len(t) > 10 for _, t in rj)
    _close([s for s, _ in rp], [s for s, _ in rj])
    kept = (probs[:, :, 0] < 0.98) & (np.arange(60) < lens[:, None])
    assert dp.frames_decoded == kept.sum(1).max() > 40


def test_wide_beam_large_batch_prefix_writes():
    """32 rows × beam 300 (where the JAX package once lost its prefix
    writes for rows ≥ 1): each row's distinct 3-token answer comes back,
    and an 8-row slice agrees row by row."""
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
            logits[b, 2 * j, t] += 14.0       # token frame
            logits[b, 2 * j + 1, 0] += 14.0   # blank separator
        logits[b, 6:, 0] += 14.0
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    lens = np.full((bsz,), t_max, np.int32)
    dec = T.TorchBeamSearchDecoder(vocab, beam_size=300, device='cpu')
    states = dec.decode_batch_states(probs, lens)
    hyps = [h for _, h in T.beam_state_to_results(states, vocab)]
    assert hyps == answers, list(zip(hyps, answers))[:4]
    best = T._logaddexp(states.p_b, states.p_nb).argmax(1)
    assert (states.lengths[torch.arange(bsz), best] == 3).all()
    dec8 = T.TorchBeamSearchDecoder(vocab, beam_size=300, device='cpu')
    assert [h for _, h in dec8.decode_batch(probs[:8], lens[:8])] == hyps[:8]


def _letters_lm(tmp_path, order=3):
    return random_arpa(tmp_path / f'letters{order}.arpa', VOCAB[1:],
                       order=order, seed=order, n_per_order=150, absent=3)


@pytest.mark.parametrize('order', [1, 2, 3])
def test_decoder_with_lm_matches_jax(tmp_path, order):
    """The decoder's LM forms: unigram only (order 1), the dense bigram
    table (order 2) and the hash tables (order 3)."""
    arpa = _letters_lm(tmp_path, order)
    rng = np.random.default_rng(6)
    probs, _ = peaky_probs(rng, 3, 30, V)
    lens = np.array([30, 22, 30])
    kw = dict(beam_size=24, cutoff_top_n=12, alpha=1.2, beta=0.4,
              language_model_path=arpa)
    dj = J.JaxBeamSearchDecoder(VOCAB, **kw)
    dp = T.TorchBeamSearchDecoder(VOCAB, device='cpu', **kw)
    assert (dp.lm_hash is None) == (dj.lm_hash is None) == (order < 3)
    assert (dp.lm_bigram is None) == (dj.lm_bigram is None) == (order != 2)
    assert_state_equal(dp.decode_batch_states(probs, lens),
                       dj.decode_batch_states(probs, lens))


def test_streaming_chunks_match_jax_and_offline(tmp_path):
    arpa = _letters_lm(tmp_path)
    rng = np.random.default_rng(7)
    probs, _ = peaky_probs(rng, 1, 40, V)
    kw = dict(beam_size=16, cutoff_top_n=10, alpha=1.0, beta=0.5,
              language_model_path=arpa)
    dj = J.JaxBeamSearchDecoder(VOCAB, **kw)
    dp = T.TorchBeamSearchDecoder(VOCAB, device='cpu', **kw)
    off = dp.decode(probs[0])
    assert dp.current() == (0.0, '')
    for chunk in np.split(probs[0], [7, 16, 30]):
        got, want = dp.decode_chunk(chunk), dj.decode_chunk(chunk)
        assert got[1] == want[1]
        _close(got[0], want[0])
    assert dp.current() == got
    assert got[1] == off[1] and len(off[1]) > 5
    _close(got[0], off[0])
    dp.reset()
    assert dp.current() == (0.0, '')


def test_logits_path_equals_probs_path():
    rng = np.random.default_rng(3)
    b, t = 3, 30
    logits = (rng.standard_normal((b, t, V)) * 3).astype(np.float32)
    logits[:, ::2, 0] += 9.0  # blank-dominated frames so compaction bites
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    lens = [t, t - 7, 5]
    for thresh in (1.0, 0.9):
        kw = dict(beam_size=8, cutoff_prob=0.99, cutoff_top_n=12, alpha=0,
                  beta=0, blank_skip_threshold=thresh)
        dp = T.TorchBeamSearchDecoder(VOCAB, device='cpu', **kw)
        rp = dp.decode_batch(probs, lens)
        rl = dp.decode_batch_from_logits(torch.from_numpy(logits), lens)
        rj = J.JaxBeamSearchDecoder(VOCAB, **kw).decode_batch_from_logits(
            jnp.asarray(logits), lens)
        assert [x for _, x in rp] == [x for _, x in rl] == [x for _, x in rj]
        _close([s for s, _ in rl], [s for s, _ in rp])
        _close([s for s, _ in rl], [s for s, _ in rj])
        assert_state_equal(
            dp.decode_batch_states_from_logits(logits, lens),
            J.JaxBeamSearchDecoder(VOCAB, **kw).decode_batch_states_from_logits(
                jnp.asarray(logits), lens))


def test_all_blank_utterance():
    probs = np.full((2, 30, V), 0.001 / (V - 1), np.float32)
    probs[:, :, 0] = 0.999
    probs /= probs.sum(-1, keepdims=True)
    lens = [30, 17]
    kw = dict(beam_size=6, cutoff_prob=0.99, cutoff_top_n=10, alpha=0,
              beta=0)
    dc = T.TorchBeamSearchDecoder(VOCAB, device='cpu',
                                  blank_skip_threshold=0.98, **kw)
    df = T.TorchBeamSearchDecoder(VOCAB, device='cpu',
                                  blank_skip_threshold=1.0, **kw)
    rc, rf = dc.decode_batch(probs, lens), df.decode_batch(probs, lens)
    assert [t for _, t in rc] == [t for _, t in rf] == ['', '']
    states = dc.decode_batch_states(probs, lens)
    prefixes, lengths, scores = T.all_hypotheses(states, 8)
    assert lengths[scores > -1e15].max() == 0
    assert_state_equal(states, J.JaxBeamSearchDecoder(
        VOCAB, blank_skip_threshold=0.98, **kw).decode_batch_states(
        jnp.asarray(probs), lens))


def test_lm_cache_round_trip_between_packages(tmp_path):
    """A <arpa>.tpu_lm.npz written by either package loads in the other
    without a rebuild, with equal tables; a vocabulary change rebuilds."""
    arpa = _letters_lm(tmp_path)
    cache = arpa + '.tpu_lm.npz'
    kw = dict(beam_size=4, alpha=1.0, beta=0.0, language_model_path=arpa)

    def same(port, jax_dec):
        for a, b in zip(port.lm_hash.tensors(),
                        jax.tree.leaves(jax_dec.lm_hash)):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(b).astype(a.numpy().dtype))

    dj = J.JaxBeamSearchDecoder(VOCAB, **kw)            # JAX writes
    mtime = os.path.getmtime(cache)
    dp = T.TorchBeamSearchDecoder(VOCAB, device='cpu', **kw)
    assert os.path.getmtime(cache) == mtime             # the port reads
    same(dp, dj)
    os.remove(cache)
    dp = T.TorchBeamSearchDecoder(VOCAB, device='cpu', **kw)  # port writes
    mtime = os.path.getmtime(cache)
    dj = J.JaxBeamSearchDecoder(VOCAB, **kw)
    assert os.path.getmtime(cache) == mtime             # JAX reads
    same(dp, dj)
    vocab2 = ['<blank>', 'b', 'a'] + VOCAB[3:]
    d3 = T.TorchBeamSearchDecoder(vocab2, device='cpu', **kw)
    assert os.path.getmtime(cache) != mtime
    assert not torch.equal(d3.lm_hash.uni_logp, dp.lm_hash.uni_logp)
    assert not [f for f in os.listdir(tmp_path) if 'tmp' in f]


def test_pipelined_decode_matches_per_batch():
    rng = np.random.default_rng(11)
    for thresh in (1.0, 0.9):
        kw = dict(beam_size=6, cutoff_top_n=10, alpha=0, beta=0,
                  blank_skip_threshold=thresh)
        dec_a = T.TorchBeamSearchDecoder(VOCAB, device='cpu', **kw)
        dec_b = T.TorchBeamSearchDecoder(VOCAB, device='cpu', **kw)
        for n_batches in (1, 3, 5):
            batches = []
            for i in range(n_batches):
                b, t = 2 + i % 2, 18 + 6 * i
                lg = (rng.standard_normal((b, t, V)) * 3).astype(np.float32)
                lg[:, ::2, 0] += 9.0
                lens = [t] * b
                lens[0] = max(1, t - 5)
                batches.append((torch.from_numpy(lg), torch.tensor(lens)))
            ref = [dec_a.decode_batch_from_logits(lg, ln)
                   for lg, ln in batches]
            piped = list(dec_b.decode_batches_pipelined(iter(batches)))
            assert piped == ref
            fwd = list(dec_b.decode_batches_pipelined(
                iter(range(n_batches)), fwd=lambda i: batches[i]))
            assert fwd == ref


def test_klm_raises_and_missing_lm_warns(tmp_path, monkeypatch):
    klm = tmp_path / 'lm.klm'
    klm.write_bytes(b'x')
    with pytest.raises(ValueError, match='ARPA'):
        T.TorchBeamSearchDecoder(VOCAB, device='cpu',
                                 language_model_path=str(klm))
    said = []
    monkeypatch.setattr(T.logger, 'warning', said.append)
    absent = str(tmp_path / 'absent.arpa')
    dec = T.TorchBeamSearchDecoder(VOCAB, device='cpu',
                                   language_model_path=absent)
    assert dec.lm_hash is None and dec.lm_unigram is None
    assert len(said) == 1 and absent in said[0]
