"""Port parity of the Squeezeformer (ppasr_tpu_torch/models/squeezeformer.py
against ppasr_tpu/models/squeezeformer.py) at 64 dims, 2 heads, 4 blocks
with the time axis halved at block 1 and restored at block 3, the port's
seeded parameters handed to JAX through ``export_params``, dropout off:

- offline CTC log-probs on the valid frames of a ragged batch with an odd
  subsampled length (the reduce step's clip), streaming (the ``'stream'``
  time reduction, causal convs) and not (the k=5 ``'conv1d'`` reduction);
- ``forward_chunk`` over three windows, every per-scale ring cache of
  ``SqueezeformerState`` included;
- the training loss terms (CTC, attention, accuracy) and the gradient
  norm;
- the attention decoder's rescoring scores of given hypotheses;
- ``convert_params`` ∘ ``export_params`` is the identity on the flax tree.

Tolerances: log-probs, states and rescoring scores 1e-4 absolute (float32;
the Conformer's tests hold the same); loss terms 1e-5 and the gradient
norm 1e-4, relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_util import one_torch_thread  # noqa: F401
from torch_zoo_util import (NO_DROPOUT_DEC, TEXT, TEXT_LENS,
                            assert_valid_close, build_pair, chunks_match,
                            inputs, loss_and_grad_norm, offline_log_probs,
                            round_trip_is_identity)

TOL = 1e-4
ENC = dict(encoder_dim=64, output_size=64, attention_heads=2, num_blocks=4,
           reduce_idx=1, recover_idx=3, feed_forward_expansion_factor=2,
           cnn_module_kernel=7, dropout=0.0, input_dropout_rate=0.0,
           attention_dropout_rate=0.0)
DEC = dict(NO_DROPOUT_DEC, attention_heads=2, linear_units=64, num_blocks=1,
           r_num_blocks=1)


@pytest.fixture(scope='module', params=[True, False],
                ids=['streaming', 'offline'])
def pair(request):
    return request.param, build_pair('squeezeformer', ENC, DEC,
                                     streaming=request.param)


def test_offline_log_probs_match_jax(pair):
    streaming, (tm, jm, variables) = pair
    x, lens = inputs(0, t_max=154, lens=(154, 111))   # 37 frames: odd
    got, got_lens, want, want_lens = offline_log_probs(tm, jm, variables, x,
                                                       lens)
    assert got.shape[1] % 2 == 1
    np.testing.assert_array_equal(got_lens, want_lens)
    assert_valid_close(got, want, want_lens, TOL)
    k = tm.encoder.time_reduction_layer.dw_conv.kernel_size[0]
    assert k == (1 if streaming else 5)


def test_forward_chunk_matches_jax():
    tm, jm, variables = build_pair('squeezeformer', ENC, DEC, streaming=True)
    x, _ = inputs(1, t_max=200)
    state = chunks_match(tm, jm, variables, x, 3, TOL, cache=32)
    # per-scale caches: C rows at full rate, C // 2 while halved
    assert [k.shape[1] for k in state.att_k] == [32, 16, 16, 32]


def test_loss_and_grad_norm_match_jax(pair):
    streaming, (tm, jm, variables) = pair
    x, lens = inputs(2)
    terms, (got, want) = loss_and_grad_norm(tm, jm, variables, x, lens,
                                            TEXT, TEXT_LENS)
    assert set(terms) == {'loss', 'loss_ctc', 'loss_att', 'th_accuracy'}
    for k, (a, b) in terms.items():
        assert a == pytest.approx(b, rel=1e-5, abs=1e-6), k
    assert got == pytest.approx(want, rel=1e-4)


def test_rescoring_scores_match_jax(pair):
    streaming, (tm, jm, variables) = pair
    x, lens = inputs(4)
    hyps = np.array([[[1, 2, 3, 0], [4, 4, 0, 0], [7, 0, 0, 0]],
                     [[2, 9, 1, 5], [3, 0, 0, 0], [6, 8, 0, 0]]], np.int32)
    hyp_lens = np.array([[3, 2, 1], [4, 1, 2]], np.int32)
    want = jax.jit(lambda v, x, n, h, hl: jm.apply(
        v, *jm.apply(v, x, n, method='encode_for_rescore')[::2], h, hl,
        method='attention_rescore_scores'))(
        variables, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(hyps),
        jnp.asarray(hyp_lens))
    with torch.no_grad():
        t_enc, _, t_olens = tm.encode_for_rescore(torch.from_numpy(x),
                                                  torch.from_numpy(lens))
        got = tm.attention_rescore_scores(t_enc, t_olens,
                                          torch.from_numpy(hyps),
                                          torch.from_numpy(hyp_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_round_trip_is_identity():
    tm, _, _ = build_pair('squeezeformer', ENC, DEC)
    tree = round_trip_is_identity(tm)
    layer = tree['params']['encoder']['layers_0']
    for m in ('self_attn', 'ffn1', 'ffn2', 'conv_module'):
        assert layer[m]['ada_scale'].shape == (1, 1, 64)
    assert 'bias' in layer['self_attn']['linear_pos']
