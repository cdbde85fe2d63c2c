"""Train state and the train step with gradient accumulation (counterpart of
ppasr_tpu/train_state.py:19-109).

``make_train_step`` builds ``train_step(state, batches, seed)``: the batch
arrives as [accum, B, ...] micro-batches; each micro-step runs the loss
forward and backward, the gradients of the micro-steps are summed in the
parameters' ``.grad`` and divided by ``accum_grad`` (JAX's scan sum, then
the division), the metrics are averaged, and the optimizer makes one update:
optax's global-norm clip, then AdamW or SGD with the lr that the schedule
gives at the count of updates already done. The model's parameters and the
optimizer's state are updated in place (JAX returns a new state).

Each micro-step i draws from its own generators, derived from the step's
``seed`` and i as ``fold_in`` derives JAX's keys: ``'dropout'`` and
``'frontend'`` on the model's device, ``'chunk'`` on the CPU (the dynamic
chunk size is read on the host). With ``frontend`` the batches carry raw
int16 waveforms ('wav' [accum, B, S], 'wav_lens'), featurized on the
device with no gradient; else features ('speech', 'speech_lens').

The step runs under ``predict.ieee_float32()``: float32 matmuls and
convolutions in full float32 and bf16 products reduced in float32, as XLA
computes them. While a profiler records (``utils/trace``), each micro-step
records ``train.frontend``, ``train.forward`` and ``train.backward``, and
the update ``train.optimizer`` (the division by ``accum_grad``, the
replicated gradients' sync, the clip, the optimizer's step and
``zero_grad``).

Data parallelism across processes (the counterpart of ``data_mesh``,
``shard_batch`` and ``replicate``, :106-135): ``data_parallel`` wraps the
model in ``DistributedDataParallel`` over the running process group, each
rank holding its slice of the global batch. Micro-steps 0..accum−2 run
under ``no_sync()``, so one all-reduce averages the summed gradients per
update; the division by ``accum_grad``, the clip and AdamW then run alike
on every rank. With more than one rank the step keeps JAX's global-batch
arithmetic:

- ``'dropout'`` and ``'frontend'`` fold the rank in, so the ranks draw
  different masks and dither as JAX's one draw over the global batch does;
  ``'chunk'`` does not, so every rank takes the same dynamic chunk. One
  rank draws exactly the single-process streams;
- under ``length_normalized_loss`` each rank scales its attention loss by
  ``world · local tokens / global tokens``, so the average over the ranks
  is the loss over the global batch's tokens (JAX divides by the global
  count); ``th_accuracy`` is weighted the same way;
- the metrics are averaged over the ranks, the global batch's values.

On a (data, model) grid (``parallel/mesh.make_mesh``, the model sharded by
``parallel/tensor_parallel.shard_module``), ``data_parallel(state,
input_dim, mesh)`` runs DDP over the mesh's data group, and every
reduction above takes the group it belongs to: "the ranks" are the data
group (``state.rank`` is the data index, ``state.world`` the data size),
BatchNorm's moments reduce over it, and the model index folds into a
second dropout stream, ``'dropout_sharded'``, that only the dropouts over
sharded activations draw from; the replicated regions' ``'dropout'`` and
the ``'frontend'`` stream fold in the data index only, so that model peers
draw alike there. The clip's norm sums the shards' squares over the model
group and counts the replicated gradients once, after model index 0's
replicated gradients are copied to its peers. Without a mesh the groups
are the world.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ppasr_tpu_torch.optimizer.factory import (build_optimizer,
                                               clip_by_global_norm)
from ppasr_tpu_torch.models.base import BatchNorm
from ppasr_tpu_torch.parallel.distributed import all_reduce_sum
from ppasr_tpu_torch.parallel.tensor_parallel import (is_sharded,
                                                      sync_replicated_grads)
from ppasr_tpu_torch.predict import ieee_float32
from ppasr_tpu_torch.utils.trace import span

METRICS = ('loss', 'loss_att', 'loss_ctc', 'th_accuracy')


class TrainState:
    """The model, its optimizer and schedule, the clip and the count of
    updates done (``step``); after ``data_parallel`` its DDP ``replica``,
    this process's ``rank`` and the ``world`` size over the data-parallel
    ranks, and the ``mesh`` (None: the world is the data group)."""

    def __init__(self, model, optimizer, schedule, grad_clip: float,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.step = step
        self.replica = None
        self.rank, self.world = 0, 1
        self.mesh = None

    @property
    def params(self):
        return [p for p in self.model.parameters() if p.requires_grad]


def create_train_state(model, optimizer_conf: dict,
                       grad_clip: float = 5.0) -> TrainState:
    optimizer, schedule, clip = build_optimizer(
        [p for p in model.parameters() if p.requires_grad],
        dict(optimizer_conf or {}), grad_clip)
    return TrainState(model, optimizer, schedule, clip)


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``data`` (numpy's
    SeedSequence hash), the counterpart of ``jax.random.fold_in``."""
    words = np.random.SeedSequence([seed, *data]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def micro_rngs(seed: int, i: int, device, frontend: bool = False,
               rank: int = None, model_rank: int = None) -> dict:
    """Micro-step i's generators: 'dropout', 'chunk' (CPU) and, with a
    frontend, 'frontend'; ``rank`` (the data-parallel index, given when
    there is more than one) is folded into 'dropout' and 'frontend'. With
    ``model_rank`` (tensor parallelism) 'dropout_sharded' folds it into
    'dropout'."""
    step_seed = fold_in(seed, i)

    def per_rank(k):
        s = fold_in(step_seed, k)
        return s if rank is None else fold_in(s, rank)

    rngs = {'dropout': torch.Generator(device).manual_seed(per_rank(0)),
            'chunk': torch.Generator('cpu').manual_seed(
                fold_in(step_seed, 1))}
    if frontend:
        rngs['frontend'] = torch.Generator(device).manual_seed(per_rank(2))
    if model_rank is not None:
        rngs['dropout_sharded'] = torch.Generator(device).manual_seed(
            fold_in(per_rank(0), model_rank))
    return rngs


def unused_parameters(model, input_dim: int, frames: int = 256) -> list:
    """Names of the trainable parameters that the training loss does not
    reach, from one forward of a zero batch in eval mode (no dropout,
    running statistics, nothing updated) and ``autograd.grad``: the
    right-to-left decoder under ``reverse_weight`` 0, a Squeezeformer's
    time reduction or recovery past its last block."""
    device = next(model.parameters()).device
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    was_training = model.training
    model.eval()
    try:
        with torch.enable_grad(), ieee_float32():
            out = model(
                torch.zeros((2, frames, input_dim), device=device),
                torch.tensor([frames, frames // 2], device=device),
                torch.tensor([[1, 1], [1, -1]], dtype=torch.int32,
                             device=device),
                torch.tensor([2, 1], device=device))
            grads = torch.autograd.grad(out['loss'], [p for _, p in named],
                                        allow_unused=True)
    finally:
        model.train(was_training)
    return [n for (n, _), g in zip(named, grads) if g is None]


def data_parallel(state: TrainState, input_dim: int, mesh=None) -> list:
    """Wrap ``state.model`` in ``DistributedDataParallel`` over the running
    process group, or over ``mesh.data_group`` (not at all where it is one
    rank), on a rank's own card or the CPU under gloo; BatchNorm's moments
    reduce over the same group. Buffers are not broadcast: the CMVN is
    constant and ``BatchNorm``'s running statistics move alike on every
    rank. ``find_unused_parameters`` is on only where
    ``unused_parameters`` finds some. Returns their names."""
    from torch.nn.parallel import DistributedDataParallel
    model = state.model
    group = None if mesh is None else mesh.data_group
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.stats_group = group
    state.mesh = mesh
    if mesh is None:
        state.rank, state.world = dist.get_rank(), dist.get_world_size()
    else:
        state.rank, state.world = mesh.data_index, mesh.n_data
    if state.world == 1 and mesh is not None:
        return []
    device = next(model.parameters()).device
    unused = unused_parameters(model, input_dim)
    state.replica = DistributedDataParallel(
        model, device_ids=[device.index] if device.type == 'cuda' else None,
        broadcast_buffers=False, find_unused_parameters=bool(unused),
        process_group=group)
    return unused


def make_train_step(accum_grad: int = 1, frontend=None,
                    deterministic: bool = False):
    """``train_step(state, batches, seed) → metrics``: the mean over the
    micro-steps of loss, loss_att, loss_ctc and th_accuracy (0-d float32
    tensors on the device, zero where the model has no attention branch),
    and ``grad_norm``, the global norm of the averaged gradient before the
    clip. ``deterministic`` runs the forwards in eval mode (no dropout, the
    full context, no dither or feature augmentation), as the JAX model's
    ``deterministic=True``: for parity checks."""

    def train_step(state: TrainState, batches: dict, seed: int) -> dict:
        model = state.model
        net = model if state.replica is None else state.replica
        multi = state.world > 1
        mesh = state.mesh
        data_group = None if mesh is None else mesh.data_group
        tp = mesh is not None and mesh.n_model > 1
        device = next(model.parameters()).device
        model.train(not deterministic)
        if multi:
            # each micro-step's decoder targets (the texts and their <eos>)
            # here and over every rank
            tokens = (batches['text_lens'] + 1).sum(dim=1).float()
            share = tokens * state.world / all_reduce_sum(tokens.clone(),
                                                          data_group)
        sums = {}
        with ieee_float32():
            for i in range(accum_grad):
                batch = {k: v[i] for k, v in batches.items()}
                rngs = micro_rngs(seed, i, device, frontend is not None,
                                  state.rank if multi else None,
                                  mesh.model_index if tp else None)
                if frontend is not None and 'wav' in batch:
                    with span('train.frontend'):
                        speech, speech_lens = frontend(
                            batch['wav'], batch['wav_lens'],
                            rngs['frontend'], deterministic=deterministic)
                else:
                    speech, speech_lens = batch['speech'], batch['speech_lens']
                sync = state.replica is None or i == accum_grad - 1
                with contextlib.nullcontext() if sync else \
                        state.replica.no_sync():
                    with span('train.forward'):
                        out = net(speech, speech_lens, batch['text'],
                                  batch['text_lens'], rngs=rngs)
                        if multi:
                            out = _global_terms(model, out, share[i])
                    with span('train.backward'):
                        out['loss'].backward()
                for k in METRICS:
                    v = out[k]
                    v = torch.zeros((), device=device) if v is None \
                        else v.detach().float()
                    sums[k] = v if i == 0 else sums[k] + v
            with span('train.optimizer'):
                params = state.params
                for p in params:
                    if p.grad is None:       # optax decays it all the same
                        p.grad = torch.zeros_like(p)
                grads = [p.grad for p in params]
                if tp:
                    sync_replicated_grads(params, mesh)
                if accum_grad > 1:
                    torch._foreach_div_(grads, float(accum_grad))
                grad_norm = clip_by_global_norm(
                    grads, state.grad_clip,
                    [is_sharded(p) for p in params] if tp else None,
                    mesh.model_group if tp else None)
                lr = state.schedule(state.step)
                for group in state.optimizer.param_groups:
                    group['lr'] = lr
                state.optimizer.step()
                state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        metrics = {k: v / accum_grad for k, v in sums.items()}
        if multi:
            mean = all_reduce_sum(torch.stack([metrics[k] for k in METRICS]),
                                  data_group) / state.world
            metrics = dict(zip(METRICS, mean.unbind()))
        metrics['grad_norm'] = grad_norm
        return metrics

    return train_step


def _global_terms(model, out: dict, share: torch.Tensor) -> dict:
    """One rank's loss terms rescaled so that their mean over the ranks is
    the global batch's: ``share`` = world · local tokens / global tokens
    multiplies the attention loss where it is normalized by its tokens,
    and the token accuracy."""
    out = dict(out)
    if out['th_accuracy'] is not None:
        out['th_accuracy'] = out['th_accuracy'] * share
    if out['loss_att'] is not None and model.length_normalized_loss:
        out['loss_att'] = out['loss_att'] * share
        out['loss'] = model.ctc_weight * out['loss_ctc'] \
            + (1 - model.ctc_weight) * out['loss_att']
    return out
