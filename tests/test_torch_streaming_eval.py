"""Port parity of the batched streaming eval: ``streaming_encode_batch`` and
``streaming_greedy_batch`` of ppasr_tpu/models/streaming_eval.py and of the
port, on the small Conformer of tests/test_torch_models.py (JAX weights
converted with ``convert_params``), B streams of ragged length sharing one
state. Probabilities within TOL = 1e-5 (tests/test_torch_models.py's
tolerance: the frameworks sum in other orders); greedy ids and out_lens
equal."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from ppasr_tpu.models import streaming_eval as jax_eval
from ppasr_tpu_torch.models import streaming_eval

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_models import D, TOL, _build  # noqa: E402


@pytest.fixture(scope='module')
def pair():
    return _build(streaming=True)


def _inputs(seed, t_max=160):
    rng = np.random.default_rng(seed)
    lens = np.array([t_max, 97, 40], np.int32)
    x = rng.normal(size=(3, t_max, D)).astype(np.float32)
    for row, n in zip(x, lens):
        row[n:] = 0.0
    return x, lens


@pytest.mark.parametrize('chunk,left', [(4, 4), (16, 16)])
def test_streaming_encode_batch_matches_jax(pair, chunk, left):
    jm, params, tm = pair
    x, lens = _inputs(chunk)
    want, want_lens = jax_eval.streaming_encode_batch(
        jm, params, jnp.asarray(x), lens, chunk=chunk, left_chunks=left)
    got, got_lens = streaming_eval.streaming_encode_batch(
        tm, x, lens, chunk=chunk, left_chunks=left)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize('chunk,left', [(4, 4), (16, 16)])
def test_streaming_greedy_batch_matches_jax(pair, chunk, left):
    jm, params, tm = pair
    x, lens = _inputs(chunk + 1)
    ids_j, mp_j, lens_j = jax_eval.streaming_greedy_batch(
        jm, params, x, lens, chunk=chunk, left_chunks=left)
    ids_t, mp_t, lens_t = streaming_eval.streaming_greedy_batch(
        tm, x, lens, chunk=chunk, left_chunks=left)
    np.testing.assert_array_equal(lens_t, lens_j)
    assert ids_t.dtype == np.int32
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(mp_t, mp_j, atol=TOL, rtol=0)


def test_frames_past_the_last_window_feed_no_output(pair):
    """At 150 frames and chunk 4 the windows cover 147 frames: the JAX
    function raises on the last 3, which end no subsampling step. The port
    drops them, and its output equals JAX's on the 147 frames."""
    jm, params, tm = pair
    x, lens = _inputs(7, t_max=150)
    with pytest.raises(ValueError):
        jax_eval.streaming_encode_batch(jm, params, x, lens, chunk=4,
                                        left_chunks=4)
    want, want_lens = jax_eval.streaming_encode_batch(
        jm, params, x[:, :147], lens, chunk=4, left_chunks=4)
    got, got_lens = streaming_eval.streaming_encode_batch(
        tm, x, lens, chunk=4, left_chunks=4)
    np.testing.assert_array_equal(got_lens, want_lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
