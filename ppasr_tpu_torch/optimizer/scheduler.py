"""Learning-rate schedules as step → lr functions (counterpart of
ppasr_tpu/optimizer/scheduler.py:16-104):

- ``warmup_lr_schedule`` (:16-30): lr = peak·warmup^0.5·min(s^-0.5,
  s·warmup^-1.5) with s = step + 1, floored at ``min_lr`` once past the
  warm-up;
- ``noam_hold_annealing_schedule`` (:33-57): linear warm-up → hold →
  polynomial decay;
- ``cosine_with_warmup_schedule`` (:60-75): linear warm-up → cosine to
  ``eta_min``.

``step`` is the count of optimizer updates already done: optax evaluates
the schedule at 0 for the first update, and the port's train step sets each
update's lr from that count itself (``train_state``), not through
``LambdaLR``'s epoch bookkeeping. The arithmetic is float32, as jnp's.
"""
import math

import numpy as np

f32 = np.float32


def warmup_lr_schedule(learning_rate: float, warmup_steps: int = 25000,
                       min_lr: float = 1e-5):
    def schedule(step: int) -> float:
        s = f32(max(step + 1, 1))
        if warmup_steps == 0:
            return float(max(f32(learning_rate) * s ** f32(-0.5),
                             f32(min_lr)))
        lr = f32(learning_rate) * f32(warmup_steps ** 0.5) * min(
            s ** f32(-0.5), s * f32(warmup_steps ** -1.5))
        return float(lr if (lr > min_lr or s < warmup_steps) else f32(min_lr))
    return schedule


def noam_hold_annealing_schedule(learning_rate: float, max_steps: int,
                                 warmup_steps: int = None,
                                 warmup_ratio: float = 0.2,
                                 hold_steps: int = None,
                                 hold_ratio: float = 0.3,
                                 decay_rate: float = 1.0,
                                 min_lr: float = 1e-5):
    if warmup_steps is None:
        warmup_steps = int(warmup_ratio * max_steps) if warmup_ratio else 0
    if hold_steps is None:
        hold_steps = int(hold_ratio * max_steps) if hold_ratio else 0
    t_warm = f32(max(1.0, float(warmup_steps) ** decay_rate))

    def schedule(step: int) -> float:
        s = f32(step)
        if s <= warmup_steps:
            return float(f32(learning_rate) * (s + 1) / f32(warmup_steps + 1))
        if s < warmup_steps + hold_steps:
            return float(f32(learning_rate))
        if s > max_steps:
            return float(f32(min_lr))
        t_hold = max(f32(1.0), max(s - hold_steps, f32(0.0)) ** f32(decay_rate))
        return float(max(f32(learning_rate) * t_warm / t_hold, f32(min_lr)))
    return schedule


def cosine_with_warmup_schedule(learning_rate: float, t_max: int,
                                eta_min: float = 0.0,
                                warmup_steps: int = None,
                                warmup_ratio: float = 0.2):
    if warmup_steps is None:
        warmup_steps = int(warmup_ratio * t_max) if warmup_ratio else 0
    decay_steps = max(t_max - warmup_steps, 1)

    def schedule(step: int) -> float:
        s = f32(step)
        if s <= warmup_steps and warmup_steps > 0:
            return float(f32(learning_rate) * (s + 1) / f32(warmup_steps + 1))
        ds = f32(min(max(s - warmup_steps, 0), decay_steps))
        return float(f32(eta_min) + f32(learning_rate - eta_min) * f32(0.5)
                     * (1 + f32(math.cos(f32(math.pi) * ds / decay_steps))))
    return schedule


def build_schedule(optimizer_conf):
    """A schedule from the ``optimizer_conf`` config section (:78-104)."""
    name = optimizer_conf.get("scheduler", "WarmupLR")
    conf = dict(optimizer_conf.get("scheduler_conf", {}) or {})
    lr = float(optimizer_conf.get("learning_rate", 1e-3))
    if name == "WarmupLR":
        return warmup_lr_schedule(
            lr, warmup_steps=int(conf.get("warmup_steps", 25000)),
            min_lr=float(conf.get("min_lr", 1e-5)))
    if name == "NoamHoldAnnealing":
        return noam_hold_annealing_schedule(
            lr, max_steps=int(conf.get("max_steps", 175680)),
            warmup_steps=conf.get("warmup_steps"),
            warmup_ratio=conf.get("warmup_ratio", 0.2),
            hold_steps=conf.get("hold_steps"),
            hold_ratio=conf.get("hold_ratio", 0.3),
            decay_rate=float(conf.get("decay_rate", 1.0)),
            min_lr=float(conf.get("min_lr", 1e-5)))
    if name == "CosineWithWarmup":
        return cosine_with_warmup_schedule(
            lr, t_max=int(conf.get("T_max", conf.get("max_steps", 100000))),
            eta_min=float(conf.get("eta_min", 0.0)),
            warmup_steps=conf.get("warmup_steps"),
            warmup_ratio=conf.get("warmup_ratio", 0.2))
    raise ValueError(f"unsupported scheduler: {name}")
