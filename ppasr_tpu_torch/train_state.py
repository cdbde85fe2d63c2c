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
computes them. Data parallelism across processes (``data_mesh``,
``shard_batch``, ``replicate``) comes with DDP (ROADMAP Queue A, item 1).
"""
import numpy as np
import torch

from ppasr_tpu_torch.optimizer.factory import (build_optimizer,
                                               clip_by_global_norm)
from ppasr_tpu_torch.predict import ieee_float32

METRICS = ('loss', 'loss_att', 'loss_ctc', 'th_accuracy')


class TrainState:
    """The model, its optimizer and schedule, the clip and the count of
    updates done (``step``)."""

    def __init__(self, model, optimizer, schedule, grad_clip: float,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.step = step

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


def micro_rngs(seed: int, i: int, device, frontend: bool = False) -> dict:
    """Micro-step i's generators: 'dropout', 'chunk' (CPU) and, with a
    frontend, 'frontend'."""
    step_seed = fold_in(seed, i)
    rngs = {'dropout': torch.Generator(device).manual_seed(
                fold_in(step_seed, 0)),
            'chunk': torch.Generator('cpu').manual_seed(
                fold_in(step_seed, 1))}
    if frontend:
        rngs['frontend'] = torch.Generator(device).manual_seed(
            fold_in(step_seed, 2))
    return rngs


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
        device = next(model.parameters()).device
        model.train(not deterministic)
        sums = {}
        with ieee_float32():
            for i in range(accum_grad):
                batch = {k: v[i] for k, v in batches.items()}
                rngs = micro_rngs(seed, i, device, frontend is not None)
                if frontend is not None and 'wav' in batch:
                    speech, speech_lens = frontend(
                        batch['wav'], batch['wav_lens'], rngs['frontend'],
                        deterministic=deterministic)
                else:
                    speech, speech_lens = batch['speech'], batch['speech_lens']
                out = model(speech, speech_lens, batch['text'],
                            batch['text_lens'], rngs=rngs)
                out['loss'].backward()
                for k in METRICS:
                    v = out[k]
                    v = torch.zeros((), device=device) if v is None \
                        else v.detach().float()
                    sums[k] = v if i == 0 else sums[k] + v
            params = state.params
            for p in params:
                if p.grad is None:       # optax decays it all the same
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            if accum_grad > 1:
                torch._foreach_div_(grads, float(accum_grad))
            grad_norm = clip_by_global_norm(grads, state.grad_clip)
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group['lr'] = lr
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        metrics = {k: v / accum_grad for k, v in sums.items()}
        metrics['grad_norm'] = grad_norm
        return metrics

    return train_step
