"""Optimizer factory: config section → optimizer, global-norm clip and
schedule (counterpart of ppasr_tpu/optimizer/factory.py:12-33).

The JAX chain is ``clip_by_global_norm(grad_clip) → adamw(lr, wd)`` for
"Adam" and "AdamW" alike, and ``add_decayed_weights(wd) → sgd(lr,
momentum 0.9)`` for "Momentum". The port:

- ``torch.optim.AdamW`` with b1 0.9, b2 0.999, eps 1e-8 and the config's
  weight decay, given explicitly (its default is 1e-2). Decoupled decay
  applies to every parameter, biases and LayerNorms included, as optax's;
- ``torch.optim.SGD`` with momentum 0.9, no dampening and the decay added
  to the gradient before the momentum, as the optax chain;
- ``clip_by_global_norm``, optax's rule: the gradients are scaled by
  max / ‖g‖ only when ‖g‖ ≥ max (``clip_grad_norm_`` would divide by
  ‖g‖ + 1e-6 and always scale).

The lr is set on every update from the schedule (``train_state``).
"""
import torch

from ppasr_tpu_torch.optimizer.scheduler import build_schedule
from ppasr_tpu_torch.parallel.distributed import all_reduce_sum


def build_optimizer(params, optimizer_conf, grad_clip: float = 5.0):
    """Returns (optimizer, schedule, grad_clip) for ``params``."""
    schedule = build_schedule(optimizer_conf)
    name = optimizer_conf.get("optimizer", "Adam")
    weight_decay = float(optimizer_conf.get("weight_decay", 0.0))
    lr0 = schedule(0)
    if name in ("Adam", "AdamW"):
        opt = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif name == "Momentum":
        opt = torch.optim.SGD(params, lr=lr0, momentum=0.9, dampening=0.0,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unsupported optimizer: {name}")
    return opt, schedule, float(grad_clip)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, sharded=None,
                        group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g ← g·(max / ‖g‖) where
    ‖g‖ ≥ max, g unchanged where not (one rounding in another order than
    optax's (g / ‖g‖)·max). Returns ‖g‖ (float32, before clipping) as a
    tensor, without reading it on the host.

    Under tensor parallelism ``sharded`` flags the gradients that are this
    rank's shards: ‖g‖² is then their squares summed over the model
    ``group`` plus the replicated gradients' squares once, the whole
    model's norm on every rank."""
    keep = [i for i, g in enumerate(grads) if g is not None]
    grads = [grads[i] for i in keep]
    norms = torch.stack([n.float() for n in torch._foreach_norm(grads)])
    if sharded is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        mask = torch.tensor([bool(sharded[i]) for i in keep],
                            device=norms.device)
        squares = norms * norms
        shards = all_reduce_sum(squares[mask].sum().reshape(1), group)
        norm = torch.sqrt(shards[0] + squares[~mask].sum())
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm
