"""Port parity of the EfficientConformer
(ppasr_tpu_torch/models/efficient_conformer.py against
ppasr_tpu/models/efficient_conformer.py) at 64 dims, 2 heads, 3 blocks
with the conv stride 2 at block 1 (the kernel halved after it) and
grouped attention (group 3) in blocks 0-1, the port's seeded parameters
handed to JAX through ``export_params``, dropout off:

- offline CTC log-probs on the valid frames of a ragged batch, streaming
  and not, with the conv module's LayerNorm and with BatchNorm (its
  running statistics from flax's ``batch_stats``); a subsampled length
  that is not a multiple of the group (the padded groups) and is odd (the
  strided clip);
- ``forward_chunk`` over three windows, every per-scale cache of
  ``EffConState`` included. With group 3 the JAX stream only approximates
  the offline output (tests/test_models_zoo.py::
  test_effcon_streaming_group3_approximate): the port's stream is held to
  JAX's stream;
- the training loss terms and the gradient norm;
- the rescoring scores of given hypotheses;
- ``convert_params`` ∘ ``export_params`` is the identity on the flax tree,
  ``batch_stats`` included; ``output_factor`` is the strides' product.

Tolerances: log-probs, states and scores 1e-4 absolute (float32); loss
terms 1e-5 and the gradient norm 1e-4, relative.
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
DEC = dict(NO_DROPOUT_DEC, attention_heads=2, linear_units=64, num_blocks=1,
           r_num_blocks=1)


def enc(norm='layer_norm'):
    return dict(output_size=64, attention_heads=2, linear_units=64,
                num_blocks=3, cnn_module_kernel=15, cnn_module_norm=norm,
                dropout_rate=0.0, positional_dropout_rate=0.0,
                attention_dropout_rate=0.0, block_final_norm=False,
                efficient_conf=dict(stride_layer_idx=[1], stride=[2],
                                    group_layer_idx=[0, 1], group_size=3))


CASES = [(n, s) for n in ('layer_norm', 'batch_norm') for s in (True, False)]


@pytest.mark.parametrize('norm,streaming', CASES)
def test_offline_log_probs_match_jax(norm, streaming):
    tm, jm, variables = build_pair('efficient_conformer', enc(norm), DEC,
                                   streaming=streaming)
    x, lens = inputs(0, t_max=158, lens=(158, 111))   # 38 frames → 19
    got, got_lens, want, want_lens = offline_log_probs(tm, jm, variables, x,
                                                       lens)
    assert got.shape[1] == 19 and tm.output_factor == 2
    np.testing.assert_array_equal(got_lens, want_lens)
    assert_valid_close(got, want, want_lens, TOL)
    assert [layer.conv_module.kernel_size for layer in tm.encoder.layers] \
        == [15, 15, 7]


@pytest.mark.parametrize('norm', ['layer_norm', 'batch_norm'])
def test_forward_chunk_matches_jax_stream(norm):
    tm, jm, variables = build_pair('efficient_conformer', enc(norm), DEC,
                                   streaming=True)
    x, _ = inputs(1, t_max=200)
    state = chunks_match(tm, jm, variables, x, 3, TOL, cache=32)
    assert [k.shape[1] for k in state.att_k] == [32, 32, 16]
    assert [c.shape[1] for c in state.cnn_cache] == [14, 14, 6]


@pytest.mark.parametrize('streaming', [True, False])
def test_loss_and_grad_norm_match_jax(streaming):
    tm, jm, variables = build_pair('efficient_conformer', enc(), DEC,
                                   streaming=streaming)
    x, lens = inputs(2)
    terms, (got, want) = loss_and_grad_norm(tm, jm, variables, x, lens,
                                            TEXT, TEXT_LENS)
    assert set(terms) == {'loss', 'loss_ctc', 'loss_att', 'th_accuracy'}
    for k, (a, b) in terms.items():
        assert a == pytest.approx(b, rel=1e-5, abs=1e-6), k
    assert got == pytest.approx(want, rel=1e-4)


def test_rescoring_scores_match_jax():
    tm, jm, variables = build_pair('efficient_conformer', enc(), DEC)
    x, lens = inputs(4)
    hyps = np.array([[[1, 2, 3, 0], [4, 4, 0, 0]],
                     [[2, 9, 1, 5], [3, 0, 0, 0]]], np.int32)
    hyp_lens = np.array([[3, 2], [4, 1]], np.int32)
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


def test_round_trip_keeps_batch_stats():
    tm, _, _ = build_pair('efficient_conformer', enc('batch_norm'), DEC)
    tree = round_trip_is_identity(tm)
    stats = tree['batch_stats']['encoder']
    assert set(stats['layers_1']['conv_module']['norm']) == {'mean', 'var'}
    assert set(stats['layers_0']['conv_module']['inner']['norm']) == \
        {'mean', 'var'}
    assert tree['params']['encoder']['layers_0']['self_attn'][
        'pos_bias_u'].shape == (2, 96)
