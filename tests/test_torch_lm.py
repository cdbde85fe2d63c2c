"""Port parity of the n-gram language model and its device hash tables:
``ppasr_tpu_torch/decoders/lm.py`` (a copy of the JAX package's numpy
module) and the hash functions of ``beam_search_torch`` against the JAX
package's, on the CPU, with the committed trigram ``lm/synth_lm.arpa`` over
the flagship's 425-token vocabulary and a random order-4 ARPA.

Tolerances: hashes, table arrays and token ids exact (bit for bit); log10
scores within 1e-4 absolute plus 1e-5 relative."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppasr_tpu.decoders import beam_search_jax as J
from ppasr_tpu.decoders import lm as jax_lm
from ppasr_tpu_torch.decoders import beam_search_torch as T
from ppasr_tpu_torch.decoders import lm as port_lm

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402
from torch_tiny_artifact import random_arpa  # noqa: E402

ATOL, RTOL = 1e-4, 1e-5
SYNTH_LM = os.path.join(fx.ROOT, fx.BEAM_LM)


def _u32(x):
    """uint32 values (numpy, JAX or torch) as int64 numpy for comparison."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope='module')
def synth():
    """(vocab, JAX scorer, port scorer, JAX tables, port tables) of the
    synth trigram LM over the flagship vocabulary."""
    vocab = fx.vocabulary()
    js = jax_lm.NgramScorer(SYNTH_LM, vocab)
    ps = port_lm.NgramScorer(SYNTH_LM, vocab)
    return (vocab, js, ps, jax_lm.build_hash_tables(js, vocab),
            port_lm.build_hash_tables(ps, vocab))


def test_host_hash_helpers_match():
    rng = np.random.default_rng(0)
    for _ in range(200):
        h = int(rng.integers(0, 2 ** 32))
        assert port_lm._fmix32(h) == jax_lm._fmix32(h)
        ids = rng.integers(-1, 500, size=int(rng.integers(1, 5))).tolist()
        assert port_lm._fold_hash(ids) == jax_lm._fold_hash(ids)
    h = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(port_lm._fmix32_np(h), jax_lm._fmix32_np(h))


def test_build_chd_matches():
    rng = np.random.default_rng(3)
    h1 = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    d_j, s_j = jax_lm._build_chd(h1, h2, start_m=1 << 16)
    d_p, s_p = port_lm._build_chd(h1, h2, start_m=1 << 16)
    np.testing.assert_array_equal(d_p, d_j)
    np.testing.assert_array_equal(s_p, s_j)


def test_synth_lm_tables_equal_array_for_array(synth):
    vocab, js, ps, tj, tp = synth
    assert ps.order == js.order == 3 and ps.tables == js.tables
    assert tp['order'] == tj['order'] == 3
    for key in ('uni_logp', 'uni_found', 'uni_backoff'):
        np.testing.assert_array_equal(tp[key], tj[key])
        assert tp[key].dtype == tj[key].dtype
    assert len(tp['tables']) == len(tj['tables']) == 2
    sizes = []
    for got, want in zip(tp['tables'], tj['tables']):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        sizes.append(got[1].shape[0])
    assert sizes == [65536, 262144]


def test_host_scores_match(synth):
    vocab, js, ps, _, _ = synth
    rng = np.random.default_rng(1)
    for _ in range(300):
        prefix = rng.integers(1, len(vocab), size=int(rng.integers(0, 5)))
        tok = int(rng.integers(1, len(vocab)))
        assert ps.score(list(prefix), tok) == js.score(list(prefix), tok)


def test_device_hashes_bit_for_bit():
    """_fmix32_dev, _hash_fold and _hash_lookup against JAX's and the host
    fold, over token ids up to V = 425 and the -1 context marker."""
    rng = np.random.default_rng(2)
    h = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 0xFFFFFFFE, 0xFFFFFFFF]
    np.testing.assert_array_equal(
        _u32(T._fmix32_dev(torch.from_numpy(h.astype(np.int64)))),
        _u32(J._fmix32_dev(jnp.asarray(h))))
    np.testing.assert_array_equal(
        _u32(T._fmix32_dev(torch.from_numpy(h.astype(np.int64)))),
        _u32(jax_lm._fmix32_np(h)))
    for n in (1, 2, 3, 4):
        toks = [rng.integers(-1, 426, 300) for _ in range(n)]
        toks[0][:5] = -1
        got = T._hash_fold([torch.from_numpy(t) for t in toks])
        want = J._hash_fold([jnp.asarray(t, jnp.int32) for t in toks])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u32(g), _u32(w))
        host = [jax_lm._fold_hash([int(t[i]) for t in toks])
                for i in range(300)]
        np.testing.assert_array_equal(_u32(got[0]), [a for a, _ in host])
        np.testing.assert_array_equal(_u32(got[1]), [b for _, b in host])


def test_hash_lookup_bit_for_bit(synth):
    vocab, _, _, tj, tp = synth
    lm_j = J.hash_lm_from_tables(tj)
    lm_p = T.hash_lm_from_tables(tp)
    rng = np.random.default_rng(4)
    ids = {t: i for i, t in enumerate(vocab)}
    known = np.array([[ids[w] for w in ng] for ng in synth[1].tables[3]
                      if all(w in ids for w in ng)][:300])
    rand = rng.integers(-1, len(vocab), (300, 3))
    for toks in (known, rand):
        cols = [toks[:, i] for i in range(3)]
        h1j, h2j = J._hash_fold([jnp.asarray(c, jnp.int32) for c in cols])
        h1p, h2p = T._hash_fold([torch.from_numpy(c) for c in cols])
        fj, vj = J._hash_lookup(lm_j.ds[1], lm_j.fps[1], lm_j.logps[1],
                                h1j, h2j)
        fp, vp = T._hash_lookup(lm_p.ds[1], lm_p.fps[1], lm_p.logps[1],
                                h1p, h2p)
        np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
        hits = int(fp.sum())
        if toks is known:
            assert hits == len(known) == 300   # every trigram is found
    assert hits < 5                            # random trigrams mostly miss


def _contexts(prefixes, width):
    """Newest-first context rows, -1 padded."""
    ctx = np.full((len(prefixes), width), -1, np.int64)
    for i, p in enumerate(prefixes):
        for j, tok in enumerate(reversed(list(p)[-width:])):
            ctx[i, j] = tok
    return ctx


def _check_hash_lm_score(vocab, scorer, t_jax, t_port, order, seed,
                         known=()):
    """Random prefixes of every length, and the contexts of the n-grams
    ``known`` with their last tokens among the candidates, so that every
    order is matched and backed off from."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, len(vocab), size=k)
                for k in range(0, order + 2) for _ in range(8)]
    prefixes += [ng[:-1] for ng in known]
    n_cand = min(40, len(vocab) - 1)
    cands = np.unique(np.concatenate([[ng[-1] for ng in known][:n_cand // 2],
                                      rng.choice(np.arange(1, len(vocab)),
                                                 size=n_cand,
                                                 replace=False)]
                                      ).astype(np.int64))[:n_cand]
    ctx = _contexts(prefixes, order - 1)
    got = T._hash_lm_score(T.hash_lm_from_tables(t_port),
                           torch.from_numpy(ctx), torch.from_numpy(cands))
    want = J._hash_lm_score(J.hash_lm_from_tables(t_jax),
                            jnp.asarray(ctx, jnp.int32),
                            jnp.asarray(cands, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    host = np.array([[scorer.score(list(p), int(c)) for c in cands]
                     for p in prefixes])
    np.testing.assert_allclose(got.numpy(), host, rtol=RTOL, atol=ATOL)
    # batched: a leading axis gives the same rows
    got_b = T._hash_lm_score(T.hash_lm_from_tables(t_port),
                             torch.from_numpy(np.stack([ctx, ctx[::-1]])),
                             torch.from_numpy(np.stack([cands, cands])))
    assert torch.equal(got_b[0], got) and torch.equal(got_b[1], got.flip(0))


def test_hash_lm_score_synth_trigram(synth):
    vocab, js, _, tj, tp = synth
    ids = {t: i for i, t in enumerate(vocab)}
    known = [[ids[w] for w in ng] for ng in js.tables[3]
             if all(w in ids for w in ng)][:60]
    _check_hash_lm_score(vocab, js, tj, tp, 3, seed=5, known=known)


def test_hash_lm_score_random_order4(tmp_path):
    vocab = ['<blank>'] + [chr(ord('a') + i) for i in range(12)]
    arpa = random_arpa(tmp_path / 'o4.arpa', vocab[1:], order=4, seed=5,
                       n_per_order=50, absent=2)
    js = jax_lm.NgramScorer(arpa, vocab)
    ps = port_lm.NgramScorer(arpa, vocab)
    assert js.order == ps.order == 4
    tj = jax_lm.build_hash_tables(js, vocab)
    tp = port_lm.build_hash_tables(ps, vocab)
    for got, want in zip(tp['tables'], tj['tables']):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    _check_hash_lm_score(vocab, js, tj, tp, 4, seed=6)


def test_load_scorer_routes_by_extension(tmp_path):
    arpa = random_arpa(tmp_path / 'r.arpa', list('abcdef'), order=3, seed=1)
    scorer = port_lm.load_scorer(arpa, list('abcdef'))
    assert isinstance(scorer, port_lm.NgramScorer)
    from ppasr_tpu_torch.decoders.klm import KlmScorer, write_klm_from_scorer
    klm = str(tmp_path / 'r.klm')
    write_klm_from_scorer(klm, scorer)
    assert isinstance(port_lm.load_scorer(klm, list('abcdef')), KlmScorer)
