"""Port parity of ``compute_dtype='bfloat16'`` on the CPU: the JAX models
with the flax ``dtype`` bfloat16 against the port's ``set_compute_dtype``,
on the small Conformer of tests/test_torch_models.py and on the tiny
artifact of tests/torch_tiny_artifact.py through every entry point.

Tolerances, and why:
- LayerNorm: flax computes the statistics, scale and bias in float32 and
  rounds once to bf16; ``models/base.LayerNorm`` does the same, so the
  outputs are equal but for rare last-bit roundings (≥ 99.9 % equal, the
  rest within 2 bf16 steps of 2⁻⁸ relative). A LayerNorm with bf16
  parameters misses this by orders of magnitude (checked too).
- CTC log-probs: bf16 keeps 8 bits of mantissa, and the two packages round
  at different places (XLA on the CPU may keep intermediates in float32).
  Each package's bf16 model is compared with the float32 model: the port's
  largest and mean |Δ| must be at most 1.5 times JAX's (it is no less
  accurate), and the port's bf16 must lie within
  ``BF16_LOGPROB_TOL`` (1.0, of tests/make_torch_smoke_fixture.py) of
  JAX's bf16, with a mean |Δ| below 0.1.
- Texts: equal to JAX's under the near-tie rule
  (``make_torch_smoke_fixture.near_tie_failures``): where a text differs,
  every frame whose argmax differs has a JAX top-2 margin below
  ``BF16_LOGIT_TOL``.
"""
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppasr_tpu.decoders.greedy as jax_greedy
import ppasr_tpu.predict as jax_predict
from ppasr_tpu.models.conformer import ConformerModel as JaxConformer
from ppasr_tpu.serving import StreamingBatchEngine as JaxEngine
import ppasr_tpu_torch.decoders.greedy as port_greedy
import ppasr_tpu_torch.predict as port_predict
from ppasr_tpu_torch.models.base import LayerNorm
from ppasr_tpu_torch.models.conformer import ConformerModel
from ppasr_tpu_torch.serving import StreamingBatchEngine
from ppasr_tpu_torch.utils.checkpoint import convert_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402
from torch_tiny_artifact import speechlike, write_artifact  # noqa: E402

D, V = 80, 30
ENC = dict(output_size=64, attention_heads=4, linear_units=128, num_blocks=2,
           cnn_module_kernel=15, block_final_norm=False)
DEC = dict(attention_heads=4, linear_units=64, num_blocks=1, r_num_blocks=1)


def test_layer_norm_matches_flax_bf16():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, 50, 256)) * 3 + 1, jnp.bfloat16)
    params = {'params': {'scale': rng.normal(size=256).astype(np.float32),
                         'bias': rng.normal(size=256).astype(np.float32)}}
    want = np.asarray(fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16).apply(
        params, x).astype(jnp.float32))
    ln = LayerNorm(256, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(params['params']['scale']))
        ln.bias.copy_(torch.from_numpy(params['params']['bias']))
        xt = torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
        got = ln(xt)
        naive = torch.nn.functional.layer_norm(
            xt, (256,), ln.weight.bfloat16(), ln.bias.bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16 and ln.weight.dtype == torch.float32
    steps = np.abs(got.float().numpy() - want) / (np.abs(want) * 2 ** -8)
    assert (steps == 0).mean() >= 0.999 and steps.max() <= 2
    naive_steps = np.abs(naive.float().numpy() - want) / (np.abs(want)
                                                          * 2 ** -8)
    assert (naive_steps == 0).mean() < 0.9


@pytest.fixture(scope='module')
def models():
    """The small JAX Conformer in float32 and bf16 with one set of weights,
    and the port's, float32 and bf16."""
    rng = np.random.default_rng(3)
    mean = tuple(np.float32(v) for v in rng.normal(size=D))
    istd = tuple(np.float32(v) for v in rng.uniform(0.5, 1.5, size=D))
    conf = dict(input_size=D, vocab_size=V, streaming=True, encoder_conf=ENC,
                decoder_conf=DEC, cmvn_mean=mean, cmvn_istd=istd)
    jm = JaxConformer(**conf)
    key = jax.random.PRNGKey(3)
    params = jax.tree.map(np.asarray, jm.init(
        {'params': key, 'dropout': key, 'chunk': key}, jnp.zeros((1, 64, D)),
        jnp.asarray([64]), jnp.asarray([[1, 2]]), jnp.asarray([2]),
        deterministic=True))
    ports = []
    for dtype in (torch.float32, torch.bfloat16):
        tm = ConformerModel(D, V, True, dict(ENC), dict(DEC), cmvn_mean=mean,
                            cmvn_istd=istd)
        tm.load_state_dict(convert_params(params), strict=True)
        ports.append(tm.eval().set_compute_dtype(dtype))
    return (jm, jm.clone(dtype=jnp.bfloat16)), params, ports


def _errors(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return d.max(), d.mean()


def _check_bf16(j32, j16, t32, t16):
    """The tolerance rules of the module docstring on four [B, T, V]
    log-prob arrays."""
    j_max, j_mean = _errors(j16, j32)
    t_max, t_mean = _errors(t16, t32)
    assert 0 < t_max <= 1.5 * j_max and t_mean <= 1.5 * j_mean
    d_max, d_mean = _errors(t16, j16)
    assert d_max <= fx.BF16_LOGPROB_TOL and d_mean < 0.1


def test_offline_log_probs_match_jax_bf16(models):
    (j32, j16), params, (t32, t16) = models
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 120, D)).astype(np.float32)
    lens = np.array([120, 90])
    out = [np.asarray(m.apply(params, x, lens, method='get_ctc_log_probs')[0])
           for m in (j32, j16)]
    with torch.no_grad():
        for m in (t32, t16):
            lp, _ = m.get_ctc_log_probs(torch.from_numpy(x),
                                        torch.from_numpy(lens))
            assert lp.dtype == torch.float32
            out.append(lp.numpy())
    n = ((lens - 1) // 2 - 1) // 2         # valid output frames
    _check_bf16(*(o[0][:n[0]] for o in out))
    _check_bf16(*(o[1][:n[1]] for o in out))


def test_chunk_step_matches_jax_bf16(models):
    (j32, j16), params, (t32, t16) = models
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(2, 67, D)).astype(np.float32) for _ in range(3)]
    out = []
    for m in (j32, j16):
        state = m.apply(params, 2, 32, method='init_state')
        probs = []
        for x in xs:
            p, state = m.apply(params, x, state,
                               method='get_encoder_out_chunk')
            probs.append(np.log(np.asarray(p)))
        out.append(np.concatenate(probs, 1))
    with torch.no_grad():
        for m in (t32, t16):
            state = m.init_state(2, 32)
            assert state.att_k.dtype == m.encoder.dtype
            assert state.cnn_cache.dtype == m.encoder.dtype
            probs = []
            for x in xs:
                p, state = m.get_encoder_out_chunk(torch.from_numpy(x),
                                                   state)
                probs.append(np.log(p.numpy()))
            out.append(np.concatenate(probs, 1))
    _check_bf16(*out)


def test_weights_cast_but_layer_norms_and_cmvn_stay_float32(models):
    t16 = models[2][1]
    assert t16.encoder.dtype == torch.bfloat16
    assert t16.encoder.layers[0].self_attn.pos_bias_u.dtype == torch.bfloat16
    assert t16.decoder.left_decoder.embed.weight.dtype == torch.bfloat16
    assert t16.encoder.pe.dtype == torch.bfloat16
    assert t16.encoder.after_norm.weight.dtype == torch.float32
    assert t16.encoder.layers[0].conv_module.norm.weight.dtype == \
        torch.float32
    assert t16.encoder.global_cmvn.mean.dtype == torch.float32


@pytest.fixture(scope='module')
def predictors(tmp_path_factory):
    artifact = write_artifact(tmp_path_factory.mktemp('tiny_artifact'))
    return {device: (
        jax_predict.PPASRPredictor(model_path=artifact,
                                   use_device_frontend=device,
                                   compute_dtype='bfloat16'),
        port_predict.PPASRPredictor(model_path=artifact, use_gpu=False,
                                    use_device_frontend=device,
                                    compute_dtype='bfloat16'))
        for device in (False, True)}, artifact


def _near_ties(run_jax, run_port):
    """→ (the port's texts, the near-tie failures against JAX's)."""
    return fx.texts_under_near_ties(run_jax, (jax_predict, jax_greedy),
                                    run_port, (port_predict, port_greedy))


PATHS = {
    'predict': lambda pred, pcms: [pred.predict(p)['text'] for p in pcms],
    'predict_batch': lambda pred, pcms: [r['text'] for r in
                                         pred.predict_batch(pcms)],
    'predict_stream': lambda pred, pcms: [fx.stream_text(pred, p)
                                          for p in pcms],
}


@pytest.mark.parametrize('path', list(PATHS))
@pytest.mark.parametrize('device', [False, True], ids=['host', 'device'])
def test_entry_points_match_jax_bf16(predictors, path, device):
    jax_pred, port_pred = predictors[0][device]
    assert port_pred.model.encoder.dtype == torch.bfloat16
    pcms = [speechlike(int(s * 16000), 60 + i)
            for i, s in enumerate((2.3, 1.2, 2.9))]
    got, bad = _near_ties(lambda: PATHS[path](jax_pred, pcms),
                          lambda: PATHS[path](port_pred, pcms))
    assert not bad and all(len(t) > 3 for t in got)


def test_engine_matches_jax_bf16(predictors):
    jax_pred, port_pred = predictors[0][False]
    rng = np.random.default_rng(5)
    pcms = [speechlike(int(rng.uniform(1.5, 3.0) * 16000), 70 + i)
            for i in range(3)]
    engine = StreamingBatchEngine(port_pred, max_streams=4)
    assert engine._batch_state.att_k.dtype == torch.bfloat16
    got, bad = _near_ties(
        lambda: fx.engine_texts(JaxEngine(jax_pred, max_streams=4), pcms),
        lambda: fx.engine_texts(engine, pcms))
    assert not bad and all(len(t) > 3 for t in got)


def test_rescoring_in_bf16_matches_jax(predictors):
    """The decoder runs in bf16, its log-softmax in float32: texts equal,
    scores within 2 % (bf16 logits summed over each hypothesis)."""
    artifact = predictors[1]
    conf = dict(beam_size=24, cutoff_top_n=12, cutoff_prob=0.99, alpha=0.3,
                beta=1.5, max_hyp_len=64)
    jax_pred = jax_predict.PPASRPredictor(
        model_path=artifact, compute_dtype='bfloat16',
        decoder='attention_rescoring', decoder_configs=conf)
    port_pred = port_predict.PPASRPredictor(
        model_path=artifact, use_gpu=False, compute_dtype='bfloat16',
        decoder='attention_rescoring', decoder_configs=conf)
    assert port_pred.model.decoder.left_decoder.embed.weight.dtype == \
        torch.bfloat16
    for seed in (1,):
        pcm = speechlike(int(2.2 * 16000), seed)
        want, got = jax_pred.predict(pcm), port_pred.predict(pcm)
        assert got['text'] == want['text'] and len(want['text']) > 5
        np.testing.assert_allclose(got['score'], want['score'], rtol=0.02)


def test_unknown_compute_dtype_raises(predictors):
    with pytest.raises(ValueError, match='compute_dtype'):
        port_predict.PPASRPredictor(model_path=predictors[1], use_gpu=False,
                                    compute_dtype='float16')
