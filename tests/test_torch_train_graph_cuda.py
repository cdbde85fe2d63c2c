"""The train step's CUDA graphs on the card (the ``gpu`` marker; each test
skips itself without a card). No JAX here:

    python -m pytest --noconftest -m gpu tests/test_torch_train_graph_cuda.py

A step that ``train_state.replays_graphs`` admits runs each padded shape's
first micro-step through ``eager_micro_step``, captures the forward and
backward graphs at the second and replays them from there on. Each test
holds such a step against the same updates made of ``eager_micro_step``
calls and ``optimizer_update`` (the functions the step itself runs for a
new shape and for the update), from the same weights, batches and seeds:

- the flagship (the committed checkpoint's Conformer), accum_grad 4, the
  device frontend with the dither, SpecAugment and SpecSub, dropout on,
  three updates over two padded shapes (the third back at the first, so
  its micro-step 0 replays too), the replayed micro-steps' chunk draws
  taking both the full context and a small chunk; and again with one
  pair held, so that the third update's shape, evicted, is captured anew;
- the Squeezeformer and the EfficientConformer at their configs' widths,
  two updates of one shape: they capture cleanly and replay.

A replay draws the eager micro-step's dropout bits and chunk and runs the
same kernels in the same order: the forward's loss terms come out bit for
bit. What differs is the order of the backward's atomic adds (the
scatter-adds of the CTC emissions' backward, cuDNN's weight gradients),
so each update, from one state on both sides, is held to float32
round-off: the metrics within 1e-6 relative (the gradient norm read
1.3e-7 on the card); each clipped gradient leaf within 1e-5 of its
largest |value| plus 1e-6 of the largest |value| of all leaves (read
2.0e-6 and 1.2e-7; a leaf whose true gradient is 0, as an attention key
bias, holds rounding alone); the parameters after AdamW within 2·lr
each, and within 1e-2·lr for all but 1e-3 of them (read 0.15·lr and 9e-5:
Adam's early updates are lr·m/(√v + eps), which a near-zero gradient's
rounding can move by up to lr).

The counters read eager 1, captures 1, replays 3 for each new shape.
DeepSpeech2 (packed RNNs), a DDP ``replica`` and a ``mesh`` step run every
micro-step eagerly and capture nothing.
"""
import copy
import os
import socket
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_torch_smoke_fixture import speechlike  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCUM, ROWS = 4, 4
METRICS = ('loss', 'loss_att', 'loss_ctc', 'th_accuracy', 'grad_norm')


def _card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs replay on a card only")
    return torch.device('cuda:0')


def _vocab_size():
    with open(os.path.join(ROOT, 'dataset', 'vocabulary.txt'),
              encoding='utf-8') as f:
        return sum(1 for line in f if line.strip())


def _frontend():
    import json
    from ppasr_tpu_torch.ops.frontend import make_device_frontend
    with open(os.path.join(ROOT, 'configs', 'augmentation.json'),
              encoding='utf-8') as f:
        return make_device_frontend({'n_mels': 80}, json.load(f))


def _batch(dev, seconds, max_tokens, vocab, seed):
    """ACCUM × ROWS speech-like utterances padded to ``seconds`` (the
    longest fills it) with up to ``max_tokens`` labels each, as
    [ACCUM, ROWS, ...] tensors on ``dev``."""
    rng = np.random.default_rng(seed)
    n, s = ACCUM * ROWS, int(seconds * 16000) // 160 * 160
    lens = rng.integers(s // 2, s + 1, n)
    lens[rng.integers(n)] = s
    wav = np.zeros((n, s), np.float32)
    for i, m in enumerate(lens):
        wav[i, :m] = speechlike(int(m), seed=seed * 100 + i)
    tl = rng.integers(max_tokens // 2, max_tokens + 1, n)
    tl[rng.integers(n)] = max_tokens
    text = np.full((n, max_tokens), -1, np.int64)
    for i, m in enumerate(tl):
        text[i, :m] = rng.integers(1, vocab - 1, m)
    t = lambda a: torch.from_numpy(a).to(dev).reshape(  # noqa: E731
        ACCUM, ROWS, *a.shape[1:])
    return {'wav': t(wav), 'wav_lens': t(lens), 'text': t(text),
            'text_lens': t(tl)}


def _chunk_kinds(model, batch, seed):
    """For micro-steps 1..ACCUM-1: True where the dynamic chunk draw takes
    the full context."""
    from ppasr_tpu_torch.ops.masks import draw_dynamic_chunk
    from ppasr_tpu_torch.train_state import micro_rngs
    frames = 1 + (batch['wav'].shape[-1] - 400) // 160
    t_sub = int(model.encoder.out_len(torch.tensor([frames]))[0])
    return [draw_dynamic_chunk(t_sub, micro_rngs(seed, i, 'cpu')['chunk'])[0]
            > t_sub // 2 for i in range(1, ACCUM)]


def _mixed_seed(model, batch):
    """The first seed whose replayed micro-steps draw both the full context
    and a small chunk."""
    for seed in range(1000):
        kinds = _chunk_kinds(model, batch, seed)
        if any(kinds) and not all(kinds):
            return seed
    raise AssertionError("no seed draws both chunk kinds")


def _eager_update(state, frontend, batch, seed):
    """One update as the step makes a new shape's micro-step, every
    micro-step eager: the metrics as the step returns them."""
    from ppasr_tpu_torch.predict import ieee_float32
    from ppasr_tpu_torch.train_state import (METRICS as TERMS,
                                             eager_micro_step, micro_rngs,
                                             optimizer_update)
    model = state.model
    dev = next(model.parameters()).device
    model.train(True)
    sums = dict.fromkeys(TERMS, 0.0)
    with ieee_float32():
        for i in range(ACCUM):
            rngs = micro_rngs(seed, i, dev, True)
            speech, lens = frontend(batch['wav'][i], batch['wav_lens'][i],
                                    rngs['frontend'])
            out = eager_micro_step(model, speech, lens, batch['text'][i],
                                   batch['text_lens'][i], rngs)
            for k in TERMS:
                if out[k] is not None:
                    sums[k] = sums[k] + out[k].detach().float()
        norm = optimizer_update(state, ACCUM)
    state.step += 1
    out = {k: v / ACCUM for k, v in sums.items()}
    out['grad_norm'] = norm
    return out


def _recording(state):
    """Keeps the clipped gradients the optimizer steps with."""
    seen, step = [], state.optimizer.step

    def recorded(*args, **kw):
        seen.append([p.grad.detach().clone() for p in state.params])
        return step(*args, **kw)
    state.optimizer.step = recorded
    return seen


def _compare(graphed, eager, metrics, want_metrics, lr):
    """The update's metrics, clipped gradients and parameters; then the
    eager twin takes the graphed one's parameters and optimizer state, so
    that each update starts both from one state (Adam turns a rounding
    difference in a near-zero gradient into up to lr, which the next
    update's gradients would carry)."""
    for k in METRICS:
        a, b = float(metrics[k]), float(want_metrics[k])
        assert abs(a - b) <= 1e-6 * max(abs(b), 1e-6), (k, a, b)
    g_last, e_last = graphed[1][-1], eager[1][-1]
    top = max(e.abs().max().item() for e in e_last)
    for g, e in zip(g_last, e_last):
        leaf = e.abs().max().item()
        assert (g - e).abs().max().item() <= 1e-5 * leaf + 1e-6 * top, \
            (tuple(e.shape), leaf, top)
    far = total = 0
    for p, q in zip(graphed[0].params, eager[0].params):
        d = (p.detach() - q.detach()).abs()
        assert d.max().item() <= 2 * lr * (1 + 1e-3)
        far += int((d > 1e-2 * lr).sum())
        total += d.numel()
    assert far <= 1e-3 * total, (far, total)
    eager[0].model.load_state_dict(graphed[0].model.state_dict())
    # a copy: load_state_dict keeps tensors already on the right device,
    # so the twins would share one Adam state
    eager[0].optimizer.load_state_dict(
        copy.deepcopy(graphed[0].optimizer.state_dict()))


def _twins(build, dev):
    """Two train states over models with one set of weights."""
    from ppasr_tpu_torch.train_state import create_train_state
    opt = {'optimizer': 'AdamW', 'weight_decay': 1e-6,
           'learning_rate': 1e-3, 'scheduler': 'WarmupLR',
           'scheduler_conf': {'warmup_steps': 0}}
    a, b = build().to(dev), build().to(dev)
    b.load_state_dict(a.state_dict())
    return (create_train_state(a, dict(opt), 5.0),
            create_train_state(b, dict(opt), 5.0))


def _family(use_model):
    from ppasr_tpu_torch.config import load_config
    from ppasr_tpu_torch.models.factory import build_model
    conf = load_config(os.path.join(ROOT, 'configs', f'{use_model}.yml'))

    def build():
        model = build_model(
            use_model, 80, _vocab_size(), streaming=True,
            encoder_conf=dict(conf.encoder_conf),
            decoder_conf=dict(conf.get('decoder_conf') or {}),
            model_conf=dict(conf.get('model_conf') or {}),
            mean_istd_path=os.path.join(ROOT, 'dataset', 'mean_istd.json'))
        model.init_weights(torch.Generator().manual_seed(7))
        return model
    return build


@pytest.mark.gpu
@pytest.mark.parametrize('held', [None, 1])
def test_flagship_replays_match_eager_micro_steps(held, monkeypatch):
    dev = _card()
    from test_torch_flagship_train import flagship
    from ppasr_tpu_torch.train_state import (MicroStepGraphs,
                                             make_train_step, replays_graphs)
    if held is not None:
        monkeypatch.setattr(MicroStepGraphs, 'HELD', held)
    graphed, eager = _twins(flagship, dev)
    assert replays_graphs(graphed)
    frontend = _frontend()
    vocab = _vocab_size()
    shapes = [_batch(dev, 6.0, 40, vocab, 1), _batch(dev, 4.0, 28, vocab, 2)]
    batches = [shapes[0], shapes[1], shapes[0]]
    seeds = [_mixed_seed(graphed.model, b) for b in shapes] + [12345]
    step = make_train_step(ACCUM, frontend)
    seen = (_recording(graphed), _recording(eager))
    # one pair held: the third update's shape was evicted, and is captured
    # anew after an eager micro-step
    want_counts = [(1, 1, 3), (2, 2, 6), (2, 2, 10)] if held is None else \
        [(1, 1, 3), (2, 2, 6), (3, 3, 9)]
    for batch, seed, counts in zip(batches, seeds, want_counts):
        metrics = step(graphed, batch, seed)
        want = _eager_update(eager, frontend, batch, seed)
        assert (step.eager, step.captures, step.replays) == counts
        _compare((graphed, seen[0]), (eager, seen[1]), metrics, want,
                 graphed.schedule(graphed.step - 1))
    assert len(step.graphs.pairs) == (held or 2)


@pytest.mark.gpu
@pytest.mark.parametrize('use_model', ['squeezeformer',
                                       'efficient_conformer'])
def test_zoo_replays_match_eager_micro_steps(use_model):
    dev = _card()
    from ppasr_tpu_torch.train_state import make_train_step, replays_graphs
    graphed, eager = _twins(_family(use_model), dev)
    assert replays_graphs(graphed)
    frontend = _frontend()
    batch = _batch(dev, 5.0, 30, _vocab_size(), 3)
    step = make_train_step(ACCUM, frontend)
    seen = (_recording(graphed), _recording(eager))
    for seed, counts in ((_mixed_seed(graphed.model, batch), (1, 1, 3)),
                         (54321, (1, 1, 7))):
        metrics = step(graphed, batch, seed)
        want = _eager_update(eager, frontend, batch, seed)
        assert (step.eager, step.captures, step.replays) == counts
        _compare((graphed, seen[0]), (eager, seen[1]), metrics, want,
                 graphed.schedule(graphed.step - 1))


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _eager_only(state, frontend, batch):
    from ppasr_tpu_torch.train_state import make_train_step, replays_graphs
    assert not replays_graphs(state)
    step = make_train_step(ACCUM, frontend)
    for seed in range(2):
        metrics = step(state, batch, seed)
        assert np.isfinite(float(metrics['loss']))
    assert (step.eager, step.captures, step.replays) == (2 * ACCUM, 0, 0)
    assert step.graphs is None


@pytest.mark.gpu
def test_deepspeech2_runs_eagerly():
    dev = _card()
    state, _ = _twins(_family('deepspeech2'), dev)
    _eager_only(state, _frontend(), _batch(dev, 3.0, 20, _vocab_size(), 4))


@pytest.mark.gpu
def test_replica_and_mesh_steps_run_eagerly():
    dev = _card()
    import torch.distributed as dist
    from ppasr_tpu_torch.parallel.mesh import make_mesh
    from ppasr_tpu_torch.train_state import data_parallel
    from torch_train_util import DEC, ENC
    from ppasr_tpu_torch.models.conformer import ConformerModel

    def tiny():
        model = ConformerModel(80, _vocab_size(), True, dict(ENC), dict(DEC))
        model.init_weights(torch.Generator().manual_seed(3))
        return model
    batch = _batch(dev, 3.0, 20, _vocab_size(), 5)
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{_free_port()}', world_size=1, rank=0)
    try:
        replica, meshed = _twins(tiny, dev)
        data_parallel(replica, 80)
        assert replica.replica is not None
        _eager_only(replica, _frontend(), batch)
        data_parallel(meshed, 80, make_mesh(1, 1))
        assert meshed.mesh is not None and meshed.replica is None
        _eager_only(meshed, _frontend(), batch)
    finally:
        dist.destroy_process_group()
