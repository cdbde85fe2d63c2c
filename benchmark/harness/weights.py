"""Seeded weights and CMVN constants, made on the device in a few large
draws, in float32, and handed alike to the program and the reference.

Distributions: every matrix and convolution kernel U(±√(3 / fan_in))
(variance 1 / fan_in, so the residual stream keeps its scale through the
blocks), biases U(±0.05), LayerNorm scales 1 + U(±0.1), pos_bias_u/v
U(±√(6 / (rows + cols))); the CMVN mean 12 + U(±1) and inverse deviation
1 / (2.5 + U(±0.5)) per mel bin, near what the traffic's log-mel reads."""
import math

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` (0 weights, 1 traffic, 2 audio, 3 the
    check's sample) of the run's ``--seed``."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        2, np.uint32).astype(np.uint64).view(np.uint64)[0] >> np.uint64(1))


def _scale_shift(name: str, shape):
    if name.endswith('pos_bias_u') or name.endswith('pos_bias_v'):
        return math.sqrt(6.0 / sum(shape)), 0.0
    if len(shape) >= 2:
        return math.sqrt(3.0 / math.prod(shape[1:])), 0.0
    if 'norm' in name.rsplit('.', 2)[-2] and name.endswith('.weight'):
        return 0.1, 1.0
    return 0.05, 0.0


def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: shape} → {name: float32 tensor on ``device``}."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 0))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, shift = _scale_shift(name, shape)
        out[name] = flat[at:at + n].view(shape).mul_(scale).add_(shift)
        at += n
    return out


def make_cmvn(n_mels: int, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 0) ^ 0x5EED)
    u = torch.rand(2, n_mels, generator=g, device=device) * 2 - 1
    return 12.0 + u[0], 1.0 / (2.5 + 0.5 * u[1])
