"""Port parity of the shared layers the model zoo adds, on JAX-initialized
weights converted with ``convert_params``:

- ``LinearNoSubsampling``, ``Conv2dSubsampling6`` and
  ``Conv2dSubsampling8`` (ppasr_tpu/models/subsampling.py:29-125), and
  their output lengths;
- the conv module with ``cnn_module_norm: batch_norm`` in eval mode (the
  running statistics of flax's ``batch_stats``) and in training mode (the
  batch's statistics and the running ones' update, flax's
  ``mutable=['batch_stats']``), and with the Squeezeformer's adaptive
  scale;
- a Conformer with each of the three input layers, offline.

And a fault of the reference that the port keeps (ROADMAP, "Faults of
the reference" item 5): the predictors' streaming chunk math (window 67,
stride 64, (t − 7) // 4 + 1 output frames) assumes ×4 subsampling. With
``conv2d`` one window's step gives the 16 frames the stride advances; with
``conv2d6``, ``conv2d8`` and the EfficientConformer's ``conv2d2`` (×2,
then ×2 by its stride) it gives another count, in both packages alike.

Tolerance 1e-5 absolute (float32; tests/test_torch_models.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppasr_tpu.models import subsampling as jsub
from ppasr_tpu.models.convolution import ConvolutionModule as JaxConv
from ppasr_tpu.models.factory import build_model as jax_build_model
from ppasr_tpu_torch.models import subsampling as tsub
from ppasr_tpu_torch.models.convolution import ConvolutionModule
from ppasr_tpu_torch.models.deepspeech2 import (Conv2dSubsampling4Pure,
                                                DeepSpeech2Model)
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.models.streaming import ChunkGeometry
from ppasr_tpu_torch.utils.checkpoint import convert_params
from torch_train_util import one_torch_thread  # noqa: F401

jax.config.update('jax_default_matmul_precision', 'highest')
TOL = 1e-5
D = 80
CTC_ONLY = {'ctc_weight': 1.0}     # no attention decoder to initialize


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize('name', ['linear', 'conv2d', 'conv2d6', 'conv2d8'])
def test_subsampling_matches_jax(name):
    jm = jsub.SUBSAMPLING_CLASSES[name](48)
    x = _x(0, (2, 61, D))
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    cls = tsub.subsampling_class(name)
    tm = cls(D, 48).eval()
    tm.load_state_dict(convert_params(jax.tree.map(np.asarray, variables)),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert got.shape[1] == cls.out_len(61) == jm.out_len(61)
    assert (cls.subsampling_rate, cls.right_context) == \
        (jm.subsampling_rate, jm.right_context)


@pytest.mark.parametrize('norm,adaptive,causal', [
    ('batch_norm', False, False), ('batch_norm', False, True),
    ('layer_norm', True, True), ('batch_norm', True, False)])
def test_conv_module_matches_jax(norm, adaptive, causal):
    jm = JaxConv(32, 7, norm=norm, causal=causal, adaptive_scale=adaptive)
    x = _x(1, (2, 20, 32))
    mask = np.ones((2, 1, 20), bool)
    mask[1, :, 15:] = False
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                        jnp.asarray(mask))
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * _x(3, a.shape), variables)
    if 'batch_stats' in variables:
        variables['batch_stats'] = jax.tree.map(
            np.abs, variables['batch_stats'])
    tm = ConvolutionModule(32, 7, norm=norm, causal=causal,
                           adaptive_scale=adaptive).eval()
    tm.load_state_dict(convert_params(variables), strict=True)
    want, want_cache = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got, cache = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(want_cache),
                               atol=TOL)
    if norm != 'batch_norm':
        return
    (want, _), stats = jm.apply(variables, jnp.asarray(x),
                                jnp.asarray(mask), deterministic=False,
                                mutable=['batch_stats'])
    tm.train()
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    new = stats['batch_stats']['norm']
    np.testing.assert_allclose(tm.norm.running_mean.numpy(),
                               np.asarray(new['mean']), atol=TOL)
    np.testing.assert_allclose(tm.norm.running_var.numpy(),
                               np.asarray(new['var']), atol=TOL)


@pytest.mark.parametrize('layer', ['linear', 'conv2d6', 'conv2d8'])
def test_conformer_input_layers_match_jax(layer):
    enc = dict(output_size=32, attention_heads=2, linear_units=32,
               num_blocks=1, input_layer=layer, cnn_module_kernel=7)
    jm = jax_build_model('conformer', D, 10, streaming=False,
                         encoder_conf=enc, model_conf=CTC_ONLY)
    x = _x(4, (2, 70, D))
    lens = np.array([70, 53], np.int32)
    k = jax.random.PRNGKey(5)
    variables = jax.jit(lambda k: jm.init(
        {'params': k, 'dropout': k, 'chunk': k}, jnp.asarray(x),
        jnp.asarray(lens), jnp.asarray([[1, 2], [3, -1]]),
        jnp.asarray([2, 1]), deterministic=True))(k)
    want, want_lens = jax.jit(lambda v, x, n: jm.apply(
        v, x, n, method='get_ctc_log_probs'))(variables, jnp.asarray(x),
                                              jnp.asarray(lens))
    tm = build_model('conformer', D, 10, streaming=False, encoder_conf=enc,
                     model_conf=CTC_ONLY).eval()
    tm.load_state_dict(convert_params(jax.tree.map(np.asarray, variables)),
                       strict=True)
    with torch.no_grad():
        got, got_lens = tm.get_ctc_log_probs(torch.from_numpy(x),
                                             torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for b, n in enumerate(np.asarray(want_lens)):
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n], atol=1e-4)


# the predictors' chunk math (ppasr_tpu/predict.py:143-146, the port's
# models/streaming.ChunkGeometry): window (16 − 1)·4 + 7 = 67 frames, stride
# 64, and (67 − 7) // 4 + 1 = 16 output frames assumed per window
WINDOW, STRIDE, ASSUMED = 67, 64, 16


def test_geometry_is_the_predictors_chunk_math():
    """The one geometry every streaming loop reads gives the numbers the
    fault below is pinned on, and its count of a window's outputs is
    DeepSpeech2's own ((t − 1) // 2 − 1) // 2 at every flush length a
    loop runs (t ≥ 7), which the engine and the predictor slice by."""
    g = ChunkGeometry(16)
    assert (g.window, g.stride, g.n_out(g.window)) == (WINDOW, STRIDE,
                                                       ASSUMED)
    assert (g.cache_size, ChunkGeometry(16, 2).cache_size) == (256, 32)
    assert (g.win_samples, g.stride_samples) == (66 * 160 + 400, 64 * 160)
    t = torch.arange(g.context, 4 * WINDOW)
    np.testing.assert_array_equal(
        g.n_out(t.numpy(), DeepSpeech2Model.output_factor),
        Conv2dSubsampling4Pure.out_len(t).numpy())


@pytest.mark.parametrize('use_model,layer,consistent', [
    ('conformer', 'conv2d', True), ('conformer', 'conv2d6', False),
    ('conformer', 'conv2d8', False),
    ('efficient_conformer', 'conv2d2', False)])
def test_chunk_math_assumes_x4_subsampling(use_model, layer, consistent):
    """Frames one streaming step emits against the frames the predictor
    reads of it and the frames its stride advances: equal only for ×4."""
    enc = dict(output_size=32, attention_heads=2, linear_units=32,
               num_blocks=2, input_layer=layer, cnn_module_kernel=7)
    if use_model == 'efficient_conformer':
        enc['efficient_conf'] = dict(stride_layer_idx=[0], stride=[2],
                                     group_layer_idx=[], group_size=3)
    tm = build_model(use_model, D, 10, streaming=True, encoder_conf=enc,
                     model_conf=CTC_ONLY).eval()
    jm = jax_build_model(use_model, D, 10, streaming=True, encoder_conf=enc,
                         model_conf=CTC_ONLY)
    k = jax.random.PRNGKey(6)
    variables = jax.jit(lambda k: jm.init(
        {'params': k, 'dropout': k, 'chunk': k}, jnp.zeros((1, WINDOW, D)),
        jnp.asarray([WINDOW]), jnp.asarray([[1, 2]]), jnp.asarray([2]),
        deterministic=True))(k)
    xs = _x(7, (1, WINDOW, D))
    want, _ = jax.jit(lambda v, x, st: jm.apply(
        v, x, st, method='get_encoder_out_chunk'))(
        variables, jnp.asarray(xs), jm.init_state(1, 64))
    with torch.no_grad():
        got, _ = tm.get_encoder_out_chunk(torch.from_numpy(xs),
                                          tm.init_state(1, 64))
    emitted = got.shape[1]
    assert emitted == want.shape[1]
    factor = tm.output_factor
    read = (ASSUMED + factor - 1) // factor
    advanced = STRIDE // (tm.subsampling_rate * factor)
    assert (emitted == read == advanced) == consistent, \
        (emitted, read, advanced)
