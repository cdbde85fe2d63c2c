"""Which train steps replay CUDA graphs (``train_state.replays_graphs``),
and that every other step keeps the eager path, on the CPU at a tiny
width (no JAX here):

- the step's eager path is bit for bit a plain loop (each
  micro-step's forward and ``backward``, the sum in ``.grad``, then the
  division by accum_grad, the clip, AdamW at the schedule's rate and
  ``zero_grad``), with dropout on and, streaming, the dynamic chunk drawn:
  metrics and parameters after two updates of accum_grad 2 are equal;
- a CPU step, a DeepSpeech2 step (packed RNNs) and a DDP-wrapped step
  (one gloo rank) count every micro-step ``eager`` and capture nothing;
- with the parameters read as on a card, a single-process Conformer is
  admitted, and a packed RNN, a DDP ``replica``, a ``mesh`` or more than
  one rank is not: the routing reads the step's own state;
- ``DeviceChunk``, the dynamic chunk as device data, writes the chunk that
  the eager draw takes from the same generator, and its mask equals the
  eager one's.
"""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ppasr_tpu_torch.models.conformer import ConformerModel
from ppasr_tpu_torch.models.deepspeech2 import DeepSpeech2Model
from ppasr_tpu_torch.ops import masks as M
from ppasr_tpu_torch.optimizer.factory import clip_by_global_norm
from ppasr_tpu_torch.predict import ieee_float32
from ppasr_tpu_torch.train_state import (METRICS, create_train_state,
                                         data_parallel, make_train_step,
                                         micro_rngs, replays_graphs)
from torch_train_util import DEC, ENC, D, V, one_torch_thread  # noqa: F401

ACCUM = 2
OPT = {'optimizer': 'AdamW', 'weight_decay': 1e-6, 'learning_rate': 1e-3,
       'scheduler': 'WarmupLR', 'scheduler_conf': {'warmup_steps': 0}}


def _conformer(streaming=True, seed=0):
    model = ConformerModel(D, V, streaming, dict(ENC), dict(DEC))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _deepspeech2():
    model = DeepSpeech2Model(D, V, True, {'num_rnn_layers': 1,
                                          'rnn_size': 16})
    model.init_weights(torch.Generator().manual_seed(1))
    return model


def _batches(seed=3, b=2, t=96, u=5):
    """[ACCUM, b, ...] features, lengths, labels (−1 padded), lengths."""
    rng = np.random.default_rng(seed)
    n = ACCUM * b
    lens = rng.integers(t // 2, t + 1, n)
    lens[0] = t
    tl = rng.integers(1, u + 1, n)
    text = np.full((n, u), -1, np.int64)
    for i, m in enumerate(tl):
        text[i, :m] = rng.integers(1, V - 1, m)
    arrays = {'speech': rng.standard_normal((n, t, D)).astype(np.float32),
              'speech_lens': lens, 'text': text, 'text_lens': tl}
    return {k: torch.from_numpy(v).reshape(ACCUM, b, *v.shape[1:])
            for k, v in arrays.items()}


def _plain_update(state, batches, seed):
    """One update as a plain loop: forward and backward per micro-step,
    the gradients summed in ``.grad``, then ÷ ACCUM, the clip and the
    optimizer's step."""
    model = state.model
    model.train(True)
    sums = {}
    with ieee_float32():
        for i in range(ACCUM):
            out = model(batches['speech'][i], batches['speech_lens'][i],
                        batches['text'][i], batches['text_lens'][i],
                        rngs=micro_rngs(seed, i, torch.device('cpu')))
            out['loss'].backward()
            for k in METRICS:
                v = out[k].detach().float()
                sums[k] = v if i == 0 else sums[k] + v
        params = state.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        torch._foreach_div_(grads, float(ACCUM))
        norm = clip_by_global_norm(grads, state.grad_clip)
        for group in state.optimizer.param_groups:
            group['lr'] = state.schedule(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    metrics = {k: v / ACCUM for k, v in sums.items()}
    metrics['grad_norm'] = norm
    return metrics


@pytest.mark.parametrize('streaming', [True, False])
def test_eager_path_is_the_plain_loop(streaming):
    stepped = create_train_state(_conformer(streaming), dict(OPT))
    plain = create_train_state(_conformer(streaming), dict(OPT))
    step = make_train_step(ACCUM)
    for seed in (11, 12):
        batches = _batches(seed)
        got = step(stepped, batches, seed)
        want = _plain_update(plain, batches, seed)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    for (n, p), q in zip(stepped.model.named_parameters(),
                         plain.model.parameters()):
        assert torch.equal(p, q), n
    assert (step.eager, step.captures, step.replays) == (2 * ACCUM, 0, 0)
    assert step.graphs is None


def _counts_eager(state, batches):
    step = make_train_step(ACCUM)
    for seed in range(2):
        assert np.isfinite(float(step(state, batches, seed)['loss']))
    assert (step.eager, step.captures, step.replays) == (2 * ACCUM, 0, 0)
    assert step.graphs is None


@pytest.mark.parametrize('build', [_conformer, _deepspeech2],
                         ids=['conformer', 'deepspeech2'])
def test_cpu_steps_run_eagerly(build):
    state = create_train_state(build(), dict(OPT))
    assert not replays_graphs(state)
    _counts_eager(state, _batches())


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def test_ddp_step_runs_eagerly():
    dist.init_process_group('gloo', init_method=f'tcp://localhost:'
                            f'{_free_port()}', world_size=1, rank=0)
    try:
        state = create_train_state(_conformer(), dict(OPT))
        data_parallel(state, D)
        assert state.replica is not None
        assert not replays_graphs(state)
        _counts_eager(state, _batches())
    finally:
        dist.destroy_process_group()


def _as_on_card(monkeypatch):
    monkeypatch.setattr(torch.Tensor, 'is_cuda',
                        property(lambda self: True))


@pytest.mark.parametrize('case, admitted', [
    ('single', True), ('rnn', False), ('replica', False), ('mesh', False),
    ('ranks', False)])
def test_routing_reads_the_step_state(monkeypatch, case, admitted):
    state = create_train_state(
        _deepspeech2() if case == 'rnn' else _conformer(), dict(OPT))
    if case == 'replica':
        state.replica = state.model
    elif case == 'mesh':
        state.mesh = object()
    elif case == 'ranks':
        state.rank, state.world = 0, 2
    _as_on_card(monkeypatch)
    assert replays_graphs(state) is admitted


@pytest.mark.parametrize('max_len', [1, 7, 40, 251])
@pytest.mark.parametrize('use_left', [False, True])
def test_device_chunk_draws_the_eager_chunk(max_len, use_left):
    pad = torch.ones((1, 1, max_len), dtype=torch.bool)
    for seed in range(40):
        eager = M.add_optional_chunk_mask(
            max_len, pad, True, use_left, 0, 0, -1,
            generator=torch.Generator().manual_seed(seed))
        chunk = M.DeviceChunk('cpu')
        M.add_optional_chunk_mask(max_len, pad, True, use_left, 0, 0, -1,
                                  generator=chunk)
        chunk.draw(torch.Generator().manual_seed(seed))
        want = M.dynamic_chunk_from_draw(
            *M.draw_dynamic_chunk(max_len,
                                  torch.Generator().manual_seed(seed)),
            max_len, use_left)
        assert tuple(chunk.sizes.tolist()) == want
        # the mask of the captured forward, as a replay computes it
        assert torch.equal(pad & M.subsequent_chunk_mask(
            max_len, *chunk.sizes)[None], eager)
    with pytest.raises(RuntimeError):
        M.add_optional_chunk_mask(max_len, pad, True, use_left, 0, 0, -1,
                                  generator=chunk)
