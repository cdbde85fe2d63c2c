"""Multi-process data-parallel training of the port (ppasr_tpu_torch/
parallel/, train_state.data_parallel, the trainer's distributed path) on
the CPU: two real gloo processes under ``torch.distributed.run`` running
``ppasr_tpu_torch.train.main`` (tests/torch_ddp_worker.py), on the
training fixture's utterances and their halves (16), a narrow
non-streaming Conformer (one block, width 32) in float32 with dropout and
the dither off, 2 updates of a global batch of 8 by SGD with momentum at
lr 0.05 (``w.PARITY_OPTIMIZER``: an update linear in the gradient, large
enough that a wrong gradient moves the weights far past the tolerances):

- against one process of the port with the same global batch: per-update
  losses and gradient norms within 1e-5 relative, final parameters within
  1e-5 (the updates move them by far more), the ranks' parameters
  bit-equal, and only rank 0 writes ``epoch_1`` and ``best_model``;
- against the JAX package's single-process step (``model.apply`` with
  ``mutable=['batch_stats']``, optax's chain) on the same global batches
  from the same initial weights (``export_params``): losses and gradient
  norms within 1e-3 relative, PERF.md §2's float32 training-parity limit,
  and the parameters' change over the two updates within 1e-3 of JAX's,
  in norm, tensor by tensor (plus ``CHANGE_FLOOR``).

Two configurations: ``layer_norm`` (accum_grad 2 under ``no_sync``,
``length_normalized_loss`` false, the pad hints of the distributed
sampler) and ``batch_norm_length_normalized`` (the conv module's
BatchNorm over the global batch, ``length_normalized_loss`` true,
accum_grad 1, ``pad_to_max``: the moments and the token count depend on
the whole global batch, so one process must see the same micro-batch and
padding). Then raw mode: the native loader, the device frontend (B1's
plain version on the CPU) with dither, SpecAugment, the audio
augmentation, dropout and the dynamic chunk: the ranks' own losses differ
and their mean is the logged loss, each micro-step's 'dropout' and
'frontend' seeds differ between the ranks and its 'chunk' seed does not,
the parameters stay bit-equal, and the CLI ``-m ppasr_tpu_torch.train``
resumes from ``last_model``. And the probe of parameters outside the loss
against a real backward, the backend taken from torchrun's environment,
and that only ``train`` starts the process group.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ddp_worker as w
from ppasr_tpu.data.dataset import ASRDataset as JaxDataset
from ppasr_tpu.data.dataset import collate_fn as jax_collate
from ppasr_tpu.models.factory import build_model as jax_build_model
from ppasr_tpu.optimizer.factory import build_optimizer as jax_optimizer
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.data.sampler import SortagradDistributedBatchSampler
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.train_state import micro_rngs, unused_parameters
from ppasr_tpu_torch.trainer import PPASRTrainer
from ppasr_tpu_torch.utils.checkpoint import (convert_params, export_params,
                                              load_msgpack)
from torch_train_util import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5      # two ranks against one process
PARAM_ATOL = 1e-5
JAX_RTOL = 1e-3       # PERF.md §2, float32 training parity
# the norm of a tensor's change that float noise alone makes where the
# gradient is 0 by construction (an attention key's bias under the softmax,
# the depthwise conv's bias before BatchNorm): up to 1.5e-8 here, against
# changes of 3e-5 and more for every other tensor
CHANGE_FLOOR = 1e-7
TIMEOUT = 300
HOST = dict(streaming=False, train_conf={'device_frontend': False})
CONFIGS = {
    'layer_norm': dict(
        model_conf={'length_normalized_loss': False},
        dataset_conf={'batch_size': 2}, train_conf={'accum_grad': 2},
        optimizer_conf=w.PARITY_OPTIMIZER),
    'batch_norm_length_normalized': dict(
        encoder_conf={'cnn_module_norm': 'batch_norm'},
        model_conf={'length_normalized_loss': True},
        dataset_conf={'batch_size': 4, 'pad_to_max': True},
        train_conf={'accum_grad': 1}, optimizer_conf=w.PARITY_OPTIMIZER),
}


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ddp'))
    w.write_corpus(root)
    return root


def _conf(root, sections, world):
    """The 2-rank config, or for ``world`` 1 the same global batch in one
    process."""
    conf = w.config(root, **HOST)
    for name, values in sections.items():
        conf[name].update(values)
    conf['dataset_conf']['batch_size'] *= 2 // world
    return conf


def _argv(root, conf, name):
    return ['--configs', w.write_config(os.path.join(root, f'{name}.yml'),
                                        conf),
            '--use_gpu', 'False', '--augment_conf_path', '',
            '--save_model_path', os.path.join(root, name, 'models'),
            '--log_dir', os.path.join(root, name, 'log')]


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def runs(request, corpus):
    """(config name, the 1-process config, the two ranks' reports, rank
    0's last_model, the one process's state and report, the initial
    weights as flax variables, the vocabulary's size)."""
    name, root = request.param, corpus
    two = _conf(root, CONFIGS[name], world=2)
    reports, _ = w.launch(os.path.join(root, f'{name}_report'),
                          _argv(root, two, f'{name}_2'), nproc=2, cwd=root,
                          dither=False, timeout=TIMEOUT)
    one = _conf(root, CONFIGS[name], world=1)
    _, state, report = w.run(_argv(root, one, f'{name}_1'), dither=False)
    last = convert_params(load_msgpack(os.path.join(
        root, f'{name}_2', 'models', 'conformer_fbank', 'last_model',
        'model.msgpack')))
    trainer = PPASRTrainer(one, use_gpu=False)
    vocab_size = trainer._build_dataset(train=False).vocab_size
    model = trainer._build_model(80, vocab_size)
    trainer._init_params(model)
    return name, one, reports, last, state, report, export_params(model), \
        vocab_size


def test_two_ranks_match_one_process(runs):
    _, _, reports, last, state, report, initial, _ = runs
    assert [r['rank'] for r in reports] == [0, 1]
    assert all(r['world'] == 2 and r['ddp'] and r['backend'] == 'gloo'
               for r in reports)
    assert not report['ddp'] and report['world'] == 1
    assert reports[0]['losses'] == reports[1]['losses']
    assert reports[0]['grad_norms'] == reports[1]['grad_norms']
    assert reports[0]['digest'] == reports[1]['digest']
    assert reports[0]['step'] == reports[1]['step'] == state.step == 2
    np.testing.assert_allclose(reports[0]['losses'], report['losses'],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(reports[0]['grad_norms'],
                               report['grad_norms'], rtol=LOSS_RTOL)
    start = convert_params(initial['params'])
    moved = max(float((last[n] - p).abs().max()) for n, p in start.items())
    assert moved > 100 * PARAM_ATOL, moved
    for n, p in state.model.state_dict().items():
        if n in last:
            np.testing.assert_allclose(last[n].numpy(), p.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=n)
    assert reports[0]['saves'] == ['epoch_1', 'best_model']
    assert reports[1]['saves'] == []


def _jax_batches(conf, vocab):
    """The global batches of epoch 0 (the manifest's order, 8 a batch) as
    JAX's collate pads them to the run's constant target, [accum, micro,
    ...]."""
    ds_conf = conf['dataset_conf']
    ds = JaxDataset(ds_conf['train_manifest'], vocab,
                    preprocess_conf=conf['preprocess_conf'], min_duration=0)
    entries = [ds.entry(i) for i in range(len(ds))]
    pad = (max(int(np.ceil(e['duration'] * 100.0)) + 4 for e in entries),
           max(len(e['text']) for e in entries))
    accum = conf['train_conf']['accum_grad']
    world_batch = ds_conf['batch_size'] * accum
    batches = []
    for start in range(0, len(ds) - world_batch + 1, world_batch):
        items = [ds[i] for i in range(start, start + world_batch)]
        x, text, x_lens, text_lens = jax_collate(items, 64, 16,
                                                 shuffle=False, pad_to=pad)
        batches.append([jnp.asarray(a.reshape(accum, -1, *a.shape[1:]))
                        for a in (x, x_lens, text, text_lens)])
    return batches


def _jax_updates(conf, initial, vocab_size):
    """JAX's single-process step from ``initial`` → (per-update losses,
    per-update gradient norms before the clip, the final params)."""
    jm = jax_build_model('conformer', 80, vocab_size, streaming=False,
                         encoder_conf=conf['encoder_conf'],
                         decoder_conf=conf['decoder_conf'],
                         model_conf=conf['model_conf'],
                         mean_istd_path=w.CMVN)
    params = initial['params']
    others = {k: v for k, v in initial.items() if k != 'params'}

    def loss(p, x, xl, t, tl):
        out, _ = jm.apply({'params': p, **others}, x, xl, t, tl,
                          deterministic=False, mutable=['batch_stats'],
                          rngs={'dropout': jax.random.PRNGKey(0)})
        return out['loss']

    grad_fn = jax.jit(jax.value_and_grad(loss))
    tx, _ = jax_optimizer(conf['optimizer_conf'],
                          grad_clip=conf['train_conf']['grad_clip'])

    @jax.jit
    def update(g, opt, p):
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt

    opt, losses, norms = tx.init(params), [], []
    for batch in _jax_batches(conf, w.VOCAB):
        accum = batch[0].shape[0]
        terms = [grad_fn(params, *(a[i] for a in batch))
                 for i in range(accum)]
        grads = jax.tree.map(lambda *g: sum(g) / accum,
                             *(g for _, g in terms))
        losses.append(float(np.mean([float(v) for v, _ in terms])))
        norms.append(float(optax.global_norm(grads)))
        params, opt = update(grads, opt, params)
    return losses, norms, params


def test_two_ranks_match_jax(runs):
    _, one, reports, last, _, _, initial, vocab_size = runs
    losses, norms, params = _jax_updates(one, initial, vocab_size)
    assert len(losses) == 2
    np.testing.assert_allclose(reports[0]['losses'], losses, rtol=JAX_RTOL)
    np.testing.assert_allclose(reports[0]['grad_norms'], norms,
                               rtol=JAX_RTOL)
    start = convert_params(initial['params'])
    want = convert_params(jax.tree.map(np.asarray, params))
    for n, p0 in start.items():
        change = float(np.linalg.norm(want[n] - p0))
        err = float(np.linalg.norm(last[n] - want[n]))
        assert err <= JAX_RTOL * change + CHANGE_FLOOR, (n, err, change)


def test_raw_native_ranks_agree_and_resume(corpus):
    root = corpus
    conf = w.config(root, dropout=True, dataset_conf={'batch_size': 2},
                    train_conf={'accum_grad': 2, 'device_frontend': True})
    argv = _argv(root, conf, 'raw')
    argv[argv.index('--augment_conf_path') + 1] = w.AUGMENTATION
    reports, _ = w.launch(os.path.join(root, 'raw_report'), argv, nproc=2,
                          cwd=root, timeout=TIMEOUT)
    assert all(r['ddp'] and r['world'] == 2 for r in reports)
    r0, r1 = reports
    assert r0['losses'] == r1['losses']
    assert np.isfinite(r0['losses']).all()
    # each rank's own loss, before the metrics' mean over the ranks
    assert all(a != b for a, b in zip(r0['local_losses'],
                                      r1['local_losses']))
    np.testing.assert_allclose(
        r0['losses'], np.mean([r0['local_losses'], r1['local_losses']], 0),
        rtol=1e-6)
    # the rank folds into the dropout masks and the dither/SpecAugment
    # streams, not into the dynamic chunk
    assert len(r0['stream_seeds']) == len(r1['stream_seeds']) == 4
    for a, b in zip(r0['stream_seeds'], r1['stream_seeds']):
        assert a['chunk'] == b['chunk']
        assert a['dropout'] != b['dropout'] and a['frontend'] != b['frontend']
    assert r0['digest'] == r1['digest']
    assert all(r['native_batches'] == 2 and r['step'] == 2 for r in reports)
    assert reports[0]['saves'] == ['epoch_1', 'best_model']
    assert reports[1]['saves'] == []
    base = os.path.join(root, 'raw', 'models', 'conformer_streaming_fbank')
    # the CLI itself resumes both ranks from last_model for a second epoch
    w.launch(None, argv + ['--overwrites', 'train_conf.max_epoch=2'],
             nproc=2, cwd=root, timeout=TIMEOUT, module=True)
    with open(os.path.join(base, 'last_model', 'model.state'),
              encoding='utf-8') as f:
        meta = json.load(f)
    # epoch 1 shuffles whole world batches of 8 after a random shift and
    # clips the remainder (the reference's distributed sampler)
    sampler = SortagradDistributedBatchSampler(16, 4, num_replicas=2)
    sampler.set_epoch(1)
    assert meta['last_epoch'] == 2 and meta['step'] == 2 + len(list(sampler))
    assert os.path.exists(os.path.join(base, 'epoch_2', 'model.msgpack'))


UNUSED_CASES = {
    'conformer_reverse_weight_0': ('conformer.yml',
                                   {'model_conf': {'reverse_weight': 0.0}}),
    'conformer': ('conformer.yml', {}),
    'squeezeformer_reduce_past_blocks': (
        'squeezeformer.yml', {'encoder_conf': {'num_blocks': 4}}),
    'deepspeech2': ('deepspeech2.yml', {}),
}


@pytest.mark.parametrize('case', sorted(UNUSED_CASES))
def test_unused_parameters_match_a_backward(case):
    name, sections = UNUSED_CASES[case]
    conf = json.loads(json.dumps(load_config(os.path.join(
        w.ROOT, 'configs', name))))
    enc, dec = conf['encoder_conf'], conf.get('decoder_conf') or {}
    for key, value in (('output_size', 32), ('encoder_dim', 32),
                       ('linear_units', 32), ('attention_heads', 2),
                       ('rnn_size', 32)):
        if key in enc:
            enc[key] = value
    if conf['use_model'] != 'deepspeech2':
        dec.update(attention_heads=2, linear_units=32)
    for section, values in sections.items():
        conf[section].update(values)
    model = build_model(conf['use_model'], 80, 12, streaming=True,
                        encoder_conf=enc, decoder_conf=dec,
                        model_conf=conf.get('model_conf'))
    model.init_weights(torch.Generator().manual_seed(0))
    found = unused_parameters(model, 80)
    model.train()
    rng = torch.Generator().manual_seed(1)
    out = model(torch.randn(2, 200, 80, generator=rng),
                torch.tensor([200, 150]), torch.tensor([[1, 2, 3], [4, 5, -1]]),
                torch.tensor([3, 2]))
    out['loss'].backward()
    none = [n for n, p in model.named_parameters()
            if p.requires_grad and p.grad is None]
    assert found == none
    assert bool(none) == case.endswith(('_0', '_blocks'))


def test_rank_folds_into_dropout_and_frontend_only():
    """Two ranks draw other dropout masks and dither, the same dynamic
    chunk; without a rank the streams are the single-process ones."""
    def draws(rank=None):
        rngs = micro_rngs(7, 1, 'cpu', frontend=True, rank=rank)
        return {k: torch.randint(0, 1 << 30, (4,), generator=g).tolist()
                for k, g in rngs.items()}
    alone, r0, r1 = draws(), draws(0), draws(1)
    assert alone == draws()
    assert r0['chunk'] == r1['chunk'] == alone['chunk']
    for k in ('dropout', 'frontend'):
        assert len({str(alone[k]), str(r0[k]), str(r1[k])}) == 3, k


TORCHRUN = dict(RANK='1', WORLD_SIZE='2', LOCAL_RANK='1',
                MASTER_ADDR='localhost', MASTER_PORT='1')


@pytest.mark.parametrize('use_gpu,local_world,cards,backend,device', [
    (False, 2, 0, 'gloo', 'cpu'),
    (True, 2, 2, 'nccl', 'cuda:1'),
    (True, 2, 1, 'gloo', 'cuda:0'),   # more ranks than cards share them
])
def test_backend_from_torchrun_env(monkeypatch, use_gpu, local_world, cards,
                                   backend, device):
    """NCCL where each local rank has a card of its own, else gloo."""
    from ppasr_tpu_torch.parallel import distributed
    started = []
    for k, v in dict(TORCHRUN, LOCAL_WORLD_SIZE=str(local_world)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    monkeypatch.setattr(torch.cuda, 'set_device', lambda d: None)
    monkeypatch.setattr(distributed.dist, 'is_initialized', lambda: False)
    monkeypatch.setattr(distributed.dist, 'init_process_group',
                        lambda b, **kw: started.append((b, kw)))
    rank, world, dev = distributed.init_distributed(use_gpu)
    assert (rank, world, str(dev)) == (1, 2, device)
    assert started == [(backend, dict(init_method='env://', rank=1,
                                      world_size=2))]


def test_only_train_joins_the_process_group(monkeypatch, corpus):
    """Building a trainer (as eval, export, tune and the data CLIs do)
    starts no process group under torchrun's environment; ``train``
    does, and raises when the environment is incomplete."""
    for k, v in TORCHRUN.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv('MASTER_ADDR')
    trainer = PPASRTrainer(w.config(corpus, **HOST), use_gpu=False)
    assert (trainer.rank, trainer.world, str(trainer.device)) == (0, 1, 'cpu')
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match='MASTER_ADDR'):
        trainer.train(save_model_path=os.path.join(corpus, 'never'))
    assert not torch.distributed.is_initialized()
