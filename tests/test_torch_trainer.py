"""The port's trainer (ppasr_tpu_torch/trainer.py, train.py) on the CPU at a
tiny width (2 encoder blocks, d 32, decoder 1 + 1 blocks) with the
flagship's recipe otherwise (configs/campaign/conformer_synth.yml: the
device frontend with dither, SpecAugment and SpecSub, the host audio
augmentation of configs/augmentation.json, accum_grad 2, WarmupLR), on six
of the training fixture's utterances written as WAVs:

- ``train`` for 2 epochs: finite losses, ``epoch_N``, ``last_model`` and
  ``best_model`` with ``model.msgpack``, ``optimizer.pt`` and
  ``model.state``; ``evaluate`` reads the checkpoint back, at full context
  and through the streaming path (the loss is the full-context one in
  both);
- resume from ``last_model``: the step count and the weights carry on;
- ``pretrained_model`` from a ``model.msgpack`` written by flax: the leaves
  whose shapes match are loaded;
- ``export_params``' msgpack read by ``flax.serialization.from_bytes`` into
  the JAX model's parameter tree, equal leaf by leaf;
- the CLI: ``--help`` and one run; ``use_gpu=True`` without a card raises,
  in the trainer and in the CLI with its default;
- ``train_conf.profile_steps: [0, 1]`` writes one ``torch.profiler``
  trace into ``<log_dir>/profile``, and the tensorboard scalars
  ``Train/Loss``, ``Train/lr``, ``Train/cer``, ``Test/cer`` and
  ``Test/Loss`` are written once per update or epoch into ``log_dir``.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import make_torch_train_fixture as tf
from ppasr_tpu.models.factory import build_model as jax_build_model
from ppasr_tpu_torch import train as train_cli
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.trainer import PPASRTrainer
from ppasr_tpu_torch.utils.checkpoint import (convert_params, export_params,
                                              load_msgpack,
                                              msgpack_serialize)
from torch_train_util import DEC, ENC, one_torch_thread  # noqa: F401

ROOT = tf.ROOT
AUG = os.path.join(ROOT, 'configs', 'augmentation.json')
N = 6


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp('train')
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
    conf = json.loads(json.dumps(load_config(tf.CONFIG)))
    conf['encoder_conf'].update(ENC)
    conf['decoder_conf'].update(DEC)
    conf['train_conf'].update(enable_amp=False, log_interval=1)
    conf['dataset_conf'].update(
        train_manifest=str(d / 'manifest.train'),
        test_manifest=str(d / 'manifest.train'),
        dataset_vocab=os.path.join(ROOT, 'dataset', 'vocabulary.txt'),
        mean_istd_path=os.path.join(ROOT, 'dataset', 'mean_istd.json'),
        batch_size=2, eval_batch_size=3, num_workers=1)
    with open(d / 'conf.yml', 'w', encoding='utf-8') as f:
        f.write(_yaml(conf))
    return d, conf


def _yaml(tree, indent=0):
    """A config dict as block YAML that the port's reader takes."""
    lines = []
    for k, v in tree.items():
        pad = ' ' * indent
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:" + (' {}' if not v else ''))
            if v:
                lines.append(_yaml(v, indent + 2))
        else:
            lines.append(f"{pad}{k}: {json.dumps(v, ensure_ascii=False)}"
                         if not isinstance(v, bool) else f"{pad}{k}: {v}")
    return '\n'.join(lines)


def _trainer(conf, **kw):
    return PPASRTrainer(json.loads(json.dumps(conf)), use_gpu=False,
                        data_augment_configs=AUG, **kw)


@pytest.fixture(scope='module')
def trained(workspace):
    d, conf = workspace
    profiled = json.loads(json.dumps(conf))
    profiled['train_conf']['profile_steps'] = [0, 1]
    trainer = _trainer(profiled, overwrites='train_conf.train_probe_size=3')
    state = trainer.train(save_model_path=str(d / 'models'),
                          log_dir=str(d / 'log'), max_epoch=2)
    return d, conf, trainer, state


def test_train_two_epochs_writes_checkpoints(trained):
    d, conf, trainer, state = trained
    losses = [float(v) for v in trainer.step_losses]
    # six utterances, batches of 2 × accum 2, the last one dropped
    assert len(losses) == 2 and state.step == 2
    assert np.isfinite(losses).all()
    base = d / 'models' / 'conformer_streaming_fbank'
    for name in ('epoch_1', 'epoch_2', 'last_model', 'best_model'):
        for f in ('model.msgpack', 'optimizer.pt', 'model.state'):
            assert (base / name / f).exists(), (name, f)
    meta = json.loads((base / 'last_model' / 'model.state').read_text())
    assert meta['last_epoch'] == 2 and meta['step'] == 2
    saved = convert_params(load_msgpack(str(base / 'last_model'
                                             / 'model.msgpack')))
    for n, p in state.model.state_dict().items():
        torch.testing.assert_close(saved[n], p, rtol=0, atol=0)
    trainer = _trainer(conf)
    err, loss = trainer.evaluate(resume_model=str(base / 'last_model'))
    assert 0.0 <= err and np.isfinite(loss)
    s_err, s_loss = trainer.evaluate(resume_model=str(base / 'last_model'),
                                     streaming_eval=True)
    assert 0.0 <= s_err and s_loss == pytest.approx(loss)


def test_resume_from_last_model(trained):
    d, conf, _, state = trained
    trainer = _trainer(conf, overwrites='train_conf.train_probe_size=0')
    resumed = trainer.train(save_model_path=str(d / 'models'), max_epoch=3)
    assert resumed.step == state.step + 1
    meta = json.loads((d / 'models' / 'conformer_streaming_fbank'
                       / 'last_model' / 'model.state').read_text())
    assert meta['last_epoch'] == 3 and meta['step'] == 3


def _jax_tree(conf, vocab_size):
    """The JAX model's parameter tree (shapes only: ``eval_shape``)."""
    jm = jax_build_model('conformer', 80, vocab_size, streaming=True,
                         encoder_conf=conf['encoder_conf'],
                         decoder_conf=conf['decoder_conf'],
                         model_conf=conf['model_conf'])
    return jax.eval_shape(lambda k: jm.init(
        {'params': k, 'dropout': k, 'chunk': k}, jnp.zeros((1, 64, 80)),
        jnp.asarray([64]), jnp.asarray([[1, 2]]), jnp.asarray([2]),
        deterministic=True), jax.random.PRNGKey(0))


def test_export_params_read_by_flax(trained):
    _, conf, _, state = trained
    target = _jax_tree(conf, state.model.vocab_size)
    blob = msgpack_serialize(export_params(state.model))
    restored = serialization.from_bytes(target, blob)
    leaves = jax.tree_util.tree_leaves_with_path(restored)
    shapes = dict(jax.tree_util.tree_leaves_with_path(target))
    assert len(leaves) == len(shapes)
    for path, leaf in leaves:
        assert leaf.shape == shapes[path].shape, path
    mine = state.model.state_dict()
    for n, v in convert_params(restored).items():
        torch.testing.assert_close(v, mine[n], rtol=0, atol=0)


def test_pretrained_from_flax_msgpack(trained, tmp_path):
    d, conf, _, state = trained
    tree = export_params(state.model)
    # a flax-written file whose ctc head has another vocabulary: skipped
    tree['params']['ctc']['ctc_lo']['bias'] = np.zeros(5, np.float32)
    path = tmp_path / 'model.msgpack'
    path.write_bytes(serialization.to_bytes(tree))
    trainer = _trainer(conf)
    model = trainer._build_model(80, state.model.vocab_size)
    trainer._init_params(model, seed=7)
    before = model.ctc.ctc_lo.bias.detach().clone()
    trainer._load_pretrained(str(tmp_path), model)
    torch.testing.assert_close(model.ctc.ctc_lo.bias, before, rtol=0,
                               atol=0)
    want = state.model.state_dict()
    for n, v in model.state_dict().items():
        if n != 'ctc.ctc_lo.bias':
            torch.testing.assert_close(v, want[n], rtol=0, atol=0)


def test_cli_help_and_run(workspace):
    d, _ = workspace
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-m', 'ppasr_tpu_torch.train',
                          '--help'], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and '--use_gpu' in out.stdout
    train_cli.main(['--configs', str(d / 'conf.yml'), '--use_gpu', 'False',
                    '--save_model_path', str(d / 'cli_models'),
                    '--augment_conf_path', AUG, '--overwrites',
                    'train_conf.max_epoch=1,train_conf.train_probe_size=0'])
    assert (d / 'cli_models' / 'conformer_streaming_fbank' / 'last_model'
            / 'model.msgpack').exists()


def test_use_gpu_without_card_raises(workspace):
    if torch.cuda.is_available():
        pytest.skip("a card is present: use_gpu=True is the normal path")
    d, conf = workspace
    with pytest.raises(RuntimeError, match='cuda'):
        PPASRTrainer(conf, use_gpu=True)
    with pytest.raises(RuntimeError, match='cuda'):
        train_cli.main(['--configs', str(d / 'conf.yml')])


def test_profile_trace_and_scalars_written(trained):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    d, _, trainer, _ = trained
    traces = os.listdir(d / 'log' / 'profile')
    assert traces == ['trace.json']
    with open(d / 'log' / 'profile' / 'trace.json', encoding='utf-8') as f:
        events = json.load(f)['traceEvents']
    assert any('aten::' in str(e.get('name', '')) for e in events)
    acc = EventAccumulator(str(d / 'log'))
    acc.Reload()
    tags = acc.Tags()['scalars']
    assert sorted(tags) == ['Test/Loss', 'Test/cer', 'Train/Loss',
                            'Train/cer', 'Train/lr']
    losses = [e.value for e in acc.Scalars('Train/Loss')]
    assert [e.step for e in acc.Scalars('Train/Loss')] == [1, 2]
    np.testing.assert_allclose(losses, [float(v) for v in
                                        trainer.step_losses], rtol=1e-6)
    assert [e.step for e in acc.Scalars('Test/cer')] == [1, 2]
