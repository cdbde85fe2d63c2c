"""Multi-process training on the card (the ``gpu`` marker; each test skips
itself without a card). No JAX here:

    python -m pytest --noconftest -m gpu tests/test_torch_ddp_cuda.py

- one NCCL rank on cuda:0 under ``torch.distributed.run
  --nproc_per_node=1`` (the process group, DDP and its all-reduce) trains
  the flagship as committed (256 × 12 blocks, bf16 AMP, the device
  frontend with dither and SpecAugment, the audio augmentation on the
  native loader) for 2 updates, and its losses are bit-equal to the same
  run without torchrun's environment; B1 is launched once per micro-batch;
- two gloo ranks, both on cuda:0 (more ranks than cards: gloo), agree
  with one process on the same global batch (the narrow model, float32,
  dropout and dither off, SGD with momentum at lr 0.05): losses and
  gradient norms within 1e-5 relative, last_model within 1e-5, the
  ranks' parameters bit-equal;
- the native loader built on this machine (g++) against the Python item
  path, transform by transform (tests/torch_native_util.py's tolerances).
"""
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ddp_worker as w  # noqa: E402
import torch_native_util as nu  # noqa: E402
from ppasr_tpu_torch.utils.checkpoint import (convert_params,  # noqa: E402
                                              load_msgpack)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("NCCL and kernel B1 need a card")


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ddp_cuda'))
    w.write_corpus(root)
    return root


def _argv(root, name, conf, *extra):
    return ['--configs', w.write_config(os.path.join(root, f'{name}.yml'),
                                        conf),
            '--save_model_path', os.path.join(root, name, 'models'),
            '--log_dir', os.path.join(root, name, 'log'), *extra]


@pytest.mark.gpu
def test_one_nccl_rank_is_bit_equal_to_the_run_alone(corpus):
    _card()
    conf = w.config(corpus, tiny=False, dropout=True,
                    dataset_conf={'batch_size': 4},
                    train_conf={'enable_amp': True, 'accum_grad': 2,
                                'device_frontend': True})
    runs = {}
    for name, nproc in (('alone', None), ('nccl', 1)):
        argv = _argv(corpus, name, conf, '--augment_conf_path',
                     w.AUGMENTATION)
        (runs[name],), _ = w.launch(os.path.join(corpus, name), argv,
                                    nproc=nproc, cwd=corpus)
    assert runs['nccl']['ddp'] and runs['nccl']['backend'] == 'nccl'
    assert not runs['alone']['ddp']
    assert runs['nccl']['losses'] == runs['alone']['losses']
    assert len(runs['alone']['losses']) == 2
    for r in runs.values():
        assert r['launches'] == 4 and r['native_batches'] == 2


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_one_process(corpus):
    _card()
    reports = {}
    for name, nproc, batch in (('one', None, 4), ('two', 2, 2)):
        conf = w.config(corpus, streaming=False,
                        dataset_conf={'batch_size': batch},
                        train_conf={'accum_grad': 2, 'device_frontend': True},
                        optimizer_conf=w.PARITY_OPTIMIZER)
        reports[name], _ = w.launch(
            os.path.join(corpus, f'gloo_{name}'),
            _argv(corpus, f'gloo_{name}', conf, '--augment_conf_path', ''),
            nproc=nproc, cwd=corpus, dither=False)
    (one,), two = reports['one'], reports['two']
    assert all(r['device'] == 'cuda:0' and r['backend'] == 'gloo'
               for r in two)
    assert two[0]['digest'] == two[1]['digest']
    assert two[0]['losses'] == pytest.approx(one['losses'], rel=1e-5)
    assert two[0]['grad_norms'] == pytest.approx(one['grad_norms'], rel=1e-5)
    want, got = (convert_params(load_msgpack(os.path.join(
        corpus, f'gloo_{name}', 'models', 'conformer_fbank', 'last_model',
        'model.msgpack'))) for name in ('one', 'two'))
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-5)
    assert two[0]['saves'] == ['epoch_1', 'best_model'] and not two[1]['saves']
    assert all(r['launches'] == 4 for r in two) and one['launches'] == 4


@pytest.mark.gpu
def test_native_loader_matches_the_item_path(corpus):
    _card()
    with open(os.path.join(corpus, 'manifest.train'), encoding='utf-8') as f:
        entries = [json.loads(line) for line in f]
    noise = nu.write_noise(os.path.join(corpus, 'noise.wav'))
    errors = nu.native_against_items(entries, noise, n_threads=4)
    assert all(errors[k] <= nu.TOLERANCES[k] for k in errors), errors
