"""Port parity of the host-side beam-search backends on the CPU:
``decoders/beam_search.py`` (the numpy oracle, ``backend: 'host'``),
``decoders/klm.py`` (KenLM probing binaries) and ``decoders/native.py``
(``backend: 'native'``, csrc/ctc_decoder.cpp built by the port with g++
into a temporary directory here), each against the JAX package's copy on
the same inputs.

Tolerances: texts, token ids and file bytes exact; scores within 1e-4
absolute plus 1e-5 relative."""
import os
import sys

import numpy as np
import pytest

from ppasr_tpu.decoders import beam_search as jax_host
from ppasr_tpu.decoders import klm as jax_klm
from ppasr_tpu.decoders.lm import NgramScorer as JaxScorer
from ppasr_tpu.decoders.native import NativeBeamSearchDecoder as JaxNative
from ppasr_tpu_torch.decoders import beam_search as port_host
from ppasr_tpu_torch.decoders import klm as port_klm
from ppasr_tpu_torch.decoders import native
from ppasr_tpu_torch.decoders.lm import NgramScorer as PortScorer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tiny_artifact import random_arpa  # noqa: E402

ATOL, RTOL = 1e-4, 1e-5
VOCAB = ['<blank>'] + [chr(ord('a') + i) for i in range(25)]
V = len(VOCAB)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _probs(seed, t, b=None, alpha=0.5):
    rng = np.random.default_rng(seed)
    size = (t,) if b is None else (b, t)
    return rng.dirichlet(np.ones(V) * alpha, size=size).astype(np.float32)


@pytest.fixture(scope='module')
def lms(tmp_path_factory):
    """A random trigram ARPA over the letters and its .klm, written by the
    port's writer."""
    tmp = tmp_path_factory.mktemp('lms')
    arpa = random_arpa(tmp / 'letters.arpa', VOCAB[1:], order=3, seed=9,
                       n_per_order=200, absent=3)
    klm = str(tmp / 'letters.klm')
    port_klm.write_klm_from_scorer(klm, PortScorer(arpa, VOCAB[1:]))
    return arpa, klm


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    """The port's native library, built with g++ into a temporary
    directory."""
    tmp = tmp_path_factory.mktemp('native_build')
    old = native.BUILD_DIR, native._lib
    native.BUILD_DIR, native._lib = tmp, None
    so = native.build()
    yield so
    native.BUILD_DIR, native._lib = old


@pytest.mark.parametrize('use_lm', [False, True], ids=['no_lm', 'arpa'])
def test_host_oracle_matches_jax(lms, use_lm):
    probs = _probs(0, 24)
    kw = dict(beam_size=12, blank=0, cutoff_prob=0.99, cutoff_top_n=15,
              alpha=1.1, beta=0.4)
    js = JaxScorer(lms[0], VOCAB) if use_lm else None
    ps = PortScorer(lms[0], VOCAB) if use_lm else None
    want = jax_host.ctc_prefix_beam_search(probs, scorer=js, **kw)
    got = port_host.ctc_prefix_beam_search(probs, scorer=ps, **kw)
    assert [p for _, p in got] == [p for _, p in want] and len(got) == 12
    _close([s for s, _ in got], [s for s, _ in want])


def test_host_decoder_batch_and_stream_match_jax(lms):
    probs = _probs(1, 20, b=3)
    lens = [20, 13, 17]
    kw = dict(alpha=0.9, beta=0.3, beam_size=10, num_processes=2,
              cutoff_prob=0.99, cutoff_top_n=12, language_model_path=lms[1])
    dj = jax_host.BeamSearchDecoder(VOCAB, **kw)
    dp = port_host.BeamSearchDecoder(VOCAB, **kw)
    assert isinstance(dp.scorer, port_klm.KlmScorer)
    want, got = dj.decode_batch(probs, lens), dp.decode_batch(probs, lens)
    assert [t for _, t in got] == [t for _, t in want]
    _close([s for s, _ in got], [s for s, _ in want])
    dp.reset()
    dj.reset()
    for chunk in np.split(probs[0], [6, 14]):
        g, w = dp.decode_chunk(chunk), dj.decode_chunk(chunk)
        assert g[1] == w[1]
        _close(g[0], w[0])
    assert g[1] == got[0][1]


def test_klm_bytes_and_scores_match_jax(lms, tmp_path):
    arpa, klm = lms
    js = JaxScorer(arpa, VOCAB)
    want = str(tmp_path / 'jax.klm')
    jax_klm.write_klm_from_scorer(want, js)
    with open(klm, 'rb') as a, open(want, 'rb') as b:
        assert a.read() == b.read()
    mp, mj = port_klm.KlmModel(klm), jax_klm.KlmModel(klm)
    assert (mp.order, mp.counts, mp.bound) == (mj.order, mj.counts, mj.bound)
    assert mp.word_id('zz-not-in-vocab') == 0
    sp, sj = port_klm.KlmScorer(klm, VOCAB), jax_klm.KlmScorer(klm, VOCAB)
    rng = np.random.default_rng(2)
    for _ in range(300):
        prefix = rng.integers(1, V, size=int(rng.integers(0, 5))).tolist()
        tok = int(rng.integers(1, V))
        assert sp.score(prefix, tok) == sj.score(prefix, tok)
        if max(prefix, default=0) < V - 3:   # no token absent from the LM
            _close(sp.score(prefix, tok), js.score(prefix, tok))
    for data in (b'', b'abcdefgh', b'abcdefghi', 'ä字'.encode()):
        assert port_klm.murmur_hash64a(data) == jax_klm.murmur_hash64a(data)
    assert port_klm.chained_hash([3, 1, 4]) == jax_klm.chained_hash([3, 1, 4])


def test_klm_rejects_garbage(tmp_path):
    bad = tmp_path / 'bad.klm'
    bad.write_bytes(b'this is not a kenlm file' * 10)
    with pytest.raises(ValueError, match='not a kenlm binary'):
        port_klm.KlmModel(str(bad))


@pytest.mark.parametrize('lm', [None, 'arpa', 'klm'])
def test_native_matches_jax_native(built, lms, lm):
    """The port's library, built from csrc/ctc_decoder.cpp, against the JAX
    package's bindings: batch decode (thread pool) and streaming."""
    path = {None: None, 'arpa': lms[0], 'klm': lms[1]}[lm]
    kw = dict(alpha=1.0, beta=0.5, beam_size=16, num_processes=2,
              cutoff_prob=0.99, cutoff_top_n=12, language_model_path=path)
    dp = native.NativeBeamSearchDecoder(VOCAB, **kw)
    dj = JaxNative(VOCAB, **kw)
    assert dp._lm_loaded == (lm is not None)
    probs = _probs(3, 30, b=3)
    lens = [30, 19, 26]
    got, want = dp.decode_batch(probs, lens), dj.decode_batch(probs, lens)
    assert got == want
    for chunk in np.split(probs[1], [9, 20]):
        g, w = dp.decode_chunk(chunk), dj.decode_chunk(chunk)
    assert g == w
    oracle = port_host.ctc_prefix_beam_search(
        probs[1, :19].astype(np.float64), 16, 0, 0.99, 12, None, 1.0, 0.5)
    if lm is None:
        assert got[1][1] == ''.join(VOCAB[i] for i in oracle[0][1])


def test_native_lm_failures(built, tmp_path, monkeypatch):
    """An LM file that exists but does not load raises; an absent one is
    named in a warning and the decoder runs LM-free."""
    bad = tmp_path / 'bad.klm'
    bad.write_bytes(b'not a model')
    with pytest.raises(RuntimeError, match='bad.klm'):
        native.NativeBeamSearchDecoder(VOCAB, language_model_path=str(bad))
    said = []
    monkeypatch.setattr(native.logger, 'warning', said.append)
    absent = str(tmp_path / 'absent.arpa')
    dec = native.NativeBeamSearchDecoder(VOCAB, language_model_path=absent)
    assert not dec._lm_loaded and len(said) == 1 and absent in said[0]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    src = tmp_path / 'broken.cpp'
    src.write_text('this is not C++\n')
    monkeypatch.setattr(native, 'SOURCE', src)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'out')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.build()
    assert not list((tmp_path / 'out').glob('*.so'))


def test_native_library_is_named_by_its_source(built):
    assert built.parent == native.BUILD_DIR
    assert built.name.startswith('libctc_decoder_') and built.exists()
    assert native.build() == built                # built once
    assert not list(built.parent.glob('*.tmp'))
