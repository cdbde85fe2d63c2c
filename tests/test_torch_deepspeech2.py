"""Port parity of DeepSpeech2 (ppasr_tpu_torch/models/deepspeech2.py against
ppasr_tpu/models/deepspeech2.py) at 2 RNN layers of 64, LSTM and GRU,
streaming (unidirectional) and not (bidirectional), the port's seeded
parameters handed to JAX through ``export_params``:

- offline CTC log-probs on the valid frames of a ragged batch, and the
  output lengths;
- the streaming step over three windows with its (h, c) state;
- the training loss and the global gradient norm (the port's over the
  parameters it trains: the bias that flax's cell lacks is held at zero);
- ``convert_params`` ∘ ``export_params`` is the identity on the flax tree,
  and after a trained update of the torch-only bias its fold keeps the
  function.

Tolerances: log-probs and states 1e-4 absolute (float32, the frameworks
sum in other orders: the Conformer's tests hold the same); the loss 1e-5
and the gradient norm 1e-4, relative.
"""
import numpy as np
import pytest
import torch

from torch_train_util import one_torch_thread  # noqa: F401
from torch_zoo_util import (TEXT, TEXT_LENS, assert_valid_close, build_pair,
                            chunks_match, inputs, loss_and_grad_norm,
                            offline_log_probs, round_trip_is_identity)

TOL = 1e-4
CASES = [(gru, streaming) for gru in (False, True)
         for streaming in (True, False)]


def _pair(gru, streaming):
    return build_pair('deepspeech2', dict(num_rnn_layers=2, rnn_size=64,
                                          use_gru=gru), streaming=streaming)


@pytest.fixture(scope='module', params=CASES,
                ids=[f"{'gru' if g else 'lstm'}-"
                     f"{'stream' if s else 'bidir'}" for g, s in CASES])
def pair(request):
    return request.param, _pair(*request.param)


def test_offline_log_probs_match_jax(pair):
    (gru, streaming), (tm, jm, variables) = pair
    x, lens = inputs()
    got, got_lens, want, want_lens = offline_log_probs(tm, jm, variables, x,
                                                       lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert_valid_close(got, want, want_lens, TOL)
    assert tm.encoder.bidirectional == (not streaming)


@pytest.mark.parametrize('gru', [False, True])
def test_streaming_chunks_match_jax(gru):
    tm, jm, variables = _pair(gru, True)
    x, _ = inputs(1, t_max=200)
    chunks_match(tm, jm, variables, x, 3, TOL, ds2=True)


def test_loss_and_grad_norm_match_jax(pair):
    (gru, streaming), (tm, jm, variables) = pair
    x, lens = inputs(2)
    terms, (got, want) = loss_and_grad_norm(tm, jm, variables, x, lens,
                                            TEXT, TEXT_LENS)
    assert set(terms) == {'loss', 'loss_ctc'}
    for k, (a, b) in terms.items():
        assert a == pytest.approx(b, rel=1e-5), k
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize('gru', [False, True])
def test_round_trip_and_bias_fold(gru):
    tm, jm, _ = _pair(gru, True)
    tree = round_trip_is_identity(tm)
    cell = tree['params']['encoder']['fwd_rnns_0']['cell']
    assert set(cell) == ({'ii', 'if', 'ig', 'io', 'hi', 'hf', 'hg', 'ho'}
                         if not gru else
                         {'ir', 'iz', 'in', 'hr', 'hz', 'hn'})
    # a checkpoint whose torch-only bias is not zero still exports the
    # function it computes
    rnn = tm.encoder.fwd_rnns[0]
    with torch.no_grad():
        extra = rnn.bias_ih_l0 if not gru else rnn.bias_hh_l0
        extra.add_(torch.linspace(-0.3, 0.3, extra.numel()))
    x, lens = inputs(3)
    from ppasr_tpu_torch.utils.checkpoint import export_params
    import jax
    import jax.numpy as jnp
    got, _, want, want_lens = offline_log_probs(
        tm, jm, jax.tree.map(jnp.asarray, export_params(tm)), x, lens)
    assert_valid_close(got, want, want_lens, TOL)
