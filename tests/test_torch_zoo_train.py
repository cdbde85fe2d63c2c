"""The port's trainer on the model zoo, on the CPU: ``PPASRTrainer.train``
takes one update of DeepSpeech2, the Squeezeformer and the
EfficientConformer from their committed configs (configs/deepspeech2.yml,
squeezeformer.yml with AdamW and NoamHoldAnnealing, efficient_conformer.yml)
at tiny widths (``torch_tiny_artifact.ZOO``), greedy evaluation, on two of
the training fixture's utterances written as WAVs. The loss is finite, the
checkpoint holds the trained weights, and the JAX package's predictor reads
the checkpoint (``flax.serialization.from_bytes`` into its own parameter
tree) and transcribes as the port's predictor does from it. The CLI,
``python -m ppasr_tpu_torch.train``, trains from configs/deepspeech2.yml as
committed, its paths and widths overwritten. And a fresh
``init_weights`` draws each family's parameters from the JAX model's
initializers: every leaf's mean and deviation within 5/sqrt(size)
deviations of a flax init's (the RNN cells' LeCun-normal and orthogonal
kernels, the Squeezeformer's scale-aware uniform ones, the grouped
attention's Xavier biases), constant leaves equal. DeepSpeech2 with
``enable_amp`` (its LSTM or GRU cells in bf16 over float32 weights, as
the flax cells with ``dtype=bf16``): one deterministic train step's loss
terms within ``BF16_LOSS_RTOL`` and its gradient norm within
``BF16_GRAD_NORM_RTOL`` of the JAX bf16 model's on the same unit-gain
``fill_weights`` parameters."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_torch_train_fixture as tf
from ppasr_tpu.models.factory import build_model as jax_build_model
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu_torch import train as train_cli
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.trainer import PPASRTrainer
from ppasr_tpu_torch.utils.checkpoint import (convert_params, export_params,
                                              load_msgpack,
                                              write_inference_artifact)
from ppasr_tpu.trainer import PPASRTrainer as JaxTrainer
from ppasr_tpu_torch.train_state import create_train_state, make_train_step
from torch_tiny_artifact import ZOO
from torch_train_util import one_torch_thread  # noqa: F401
from torch_zoo_util import TEXT, TEXT_LENS, inputs
from make_torch_zoo_fixture import fill_weights

ROOT = tf.ROOT
N = 2


@pytest.fixture(scope='module')
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp('zoo_train')
    data = tf.load()
    with open(d / 'manifest.train', 'w', encoding='utf-8') as f:
        for i, (pcm, text) in enumerate(zip(tf.pcms(data)[:N],
                                            data['texts'][:N])):
            wav = str(d / f'{i}.wav')
            AudioSegment.from_ndarray(pcm).to_wav_file(wav)
            f.write(json.dumps({'audio_filepath': wav,
                                'duration': len(pcm) / 16000,
                                'text': str(text)},
                               ensure_ascii=False) + '\n')
    return d


@pytest.mark.parametrize('use_model', sorted(ZOO))
def test_one_update_and_checkpoint_read_by_jax(manifest, use_model):
    d = manifest
    conf = json.loads(json.dumps(load_config(os.path.join(
        ROOT, 'configs', f'{use_model}.yml'))))
    enc, dec, model_conf = ZOO[use_model]
    conf['encoder_conf'] = dict(enc)
    if dec:
        conf['decoder_conf'].update(dec)
    conf['decoder'] = 'ctc_greedy'
    conf['train_conf'].update(accum_grad=1, log_interval=1,
                              train_probe_size=0)
    conf['dataset_conf'].update(
        train_manifest=str(d / 'manifest.train'),
        test_manifest=str(d / 'manifest.train'),
        dataset_vocab=os.path.join(ROOT, 'dataset', 'vocabulary.txt'),
        mean_istd_path=os.path.join(ROOT, 'dataset', 'mean_istd.json'),
        batch_size=N, eval_batch_size=N, num_workers=1)
    trainer = PPASRTrainer(conf, use_gpu=False)
    save = d / use_model
    state = trainer.train(save_model_path=str(save), max_epoch=1)
    losses = [float(v) for v in trainer.step_losses]
    assert state.step == 1 and len(losses) == 1 and np.isfinite(losses[0])
    ckpt = save / f'{use_model}_streaming_fbank' / 'last_model'
    saved = convert_params(load_msgpack(str(ckpt / 'model.msgpack')))
    for n, p in state.model.state_dict().items():
        torch.testing.assert_close(saved[n], p, rtol=0, atol=0)

    artifact = write_inference_artifact(
        str(d / f'{use_model}_artifact'), conf, str(ckpt / 'model.msgpack'),
        conf['dataset_conf']['dataset_vocab'],
        conf['dataset_conf']['mean_istd_path'])
    pcm = tf.pcms(tf.load())[N]
    want = JaxPredictor(model_path=artifact).predict(pcm)
    got = PPASRPredictor(model_path=artifact, use_gpu=False).predict(pcm)
    assert got['text'] == want['text']
    assert abs(got['score'] - want['score']) < 1e-3


def test_cli_trains_from_the_committed_config(manifest):
    d = manifest
    over = {'dataset_conf.train_manifest': d / 'manifest.train',
            'dataset_conf.test_manifest': d / 'manifest.train',
            'dataset_conf.dataset_vocab': os.path.join(
                ROOT, 'dataset', 'vocabulary.txt'),
            'dataset_conf.mean_istd_path': os.path.join(
                ROOT, 'dataset', 'mean_istd.json'),
            'dataset_conf.batch_size': N, 'dataset_conf.eval_batch_size': N,
            'dataset_conf.num_workers': 1, 'encoder_conf.num_rnn_layers': 1,
            'encoder_conf.rnn_size': 32, 'train_conf.max_epoch': 1,
            'train_conf.train_probe_size': 0}
    state = train_cli.main([
        '--configs', os.path.join(ROOT, 'configs', 'deepspeech2.yml'),
        '--use_gpu', 'False', '--save_model_path', str(d / 'cli'),
        '--augment_conf_path', '',
        '--overwrites', ','.join(f'{k}={v}' for k, v in over.items())])
    assert state.step == 1
    assert state.model.encoder.fwd_rnns[0].hidden_size == 32
    assert (d / 'cli' / 'deepspeech2_streaming_fbank' / 'last_model'
            / 'model.msgpack').exists()


@pytest.mark.parametrize('use_model,gru', [
    ('deepspeech2', False), ('deepspeech2', True), ('squeezeformer', False),
    ('efficient_conformer', False)])
def test_fresh_init_statistics_match_jax(use_model, gru):
    enc, dec, model_conf = ZOO[use_model]
    if use_model == 'deepspeech2':
        enc = dict(enc, use_gru=gru)
    kw = dict(streaming=True, encoder_conf=enc, decoder_conf=dec,
              model_conf=model_conf)
    jm = jax_build_model(use_model, 80, 30, **kw)
    params = jax.jit(lambda k: jm.init(
        {'params': k, 'dropout': k, 'chunk': k}, jnp.zeros((1, 64, 80)),
        jnp.asarray([64]), jnp.asarray([[1, 2]]), jnp.asarray([2]),
        deterministic=True))(jax.random.PRNGKey(5))
    want = convert_params(jax.tree.map(np.asarray, params))
    tm = build_model(use_model, 80, 30, **kw)
    tm.init_weights(torch.Generator().manual_seed(0))
    got = tm.state_dict()
    assert set(got) == set(want)
    for n, w in want.items():
        w = w.numpy().astype(np.float64)
        g = got[n].numpy().astype(np.float64)
        if np.all(w == w.flat[0]):            # zeros and ones
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        tol = 5 / np.sqrt(w.size) * w.std()
        assert abs(g.mean() - w.mean()) <= tol, n
        assert abs(g.std() - w.std()) <= tol, n


@pytest.mark.parametrize('gru', [False, True], ids=['lstm', 'gru'])
def test_deepspeech2_bf16_step_matches_jax(gru):
    conf = json.loads(json.dumps(load_config(os.path.join(
        ROOT, 'configs', 'campaign', 'deepspeech2_synth.yml'))))
    assert conf['train_conf']['enable_amp'] is True
    conf['encoder_conf'] = dict(ZOO['deepspeech2'][0], use_gru=gru)
    conf['dataset_conf']['mean_istd_path'] = os.path.join(
        ROOT, 'dataset', 'mean_istd.json')
    model = PPASRTrainer(conf, use_gpu=False)._build_model(80, 12)
    # unit gain: at ZOO_GAIN's 2 the saturated cells' bf16 gradient norm
    # moves some 4 % from the float32 one in either package, so the two
    # land up to 9 % apart; at unit gain each stays within 1-4 %
    fill_weights(model, 3, 1.0)
    rnn = model.encoder.fwd_rnns[0]
    assert rnn.compute_dtype == torch.bfloat16 and \
        rnn.weight_hh_l0.dtype == torch.float32
    jm = JaxTrainer(json.loads(json.dumps(conf)))._build_model(80, 12)
    variables = jax.tree.map(jnp.asarray, export_params(model))
    x, lens = inputs(seed=4)

    def f(params):
        out = jm.apply(dict(variables, params=params), jnp.asarray(x),
                       jnp.asarray(lens), jnp.asarray(TEXT),
                       jnp.asarray(TEXT_LENS), deterministic=True)
        return out['loss'], out
    (_, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables['params'])
    want_norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                                   for g in jax.tree.leaves(grads))))
    state = create_train_state(model, dict(conf['optimizer_conf']),
                               float(conf['train_conf']['grad_clip']))
    batch = {'speech': torch.from_numpy(x)[None],
             'speech_lens': torch.from_numpy(lens)[None],
             'text': torch.from_numpy(TEXT).long()[None],
             'text_lens': torch.from_numpy(TEXT_LENS)[None]}
    metrics = make_train_step(1, deterministic=True)(state, batch, 0)
    for k in ('loss', 'loss_ctc'):
        assert metrics[k].item() == pytest.approx(
            float(want[k]), rel=tf.BF16_LOSS_RTOL), k
    assert metrics['grad_norm'].item() == pytest.approx(
        want_norm, rel=tf.BF16_GRAD_NORM_RTOL)
    assert state.step == 1 and rnn.weight_hh_l0.dtype == torch.float32
