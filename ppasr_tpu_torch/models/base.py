"""Shared model plumbing (counterpart of ppasr_tpu/models/base.py):
activations, global CMVN (:42-66), dropout (:73-100), the initializers
(:8-39) and the compute dtype.

The JAX models take a flax ``dtype``: parameters stay float32 and each
Dense, Conv and Embed casts its kernel and input to the dtype, while
LayerNorm computes its statistics, scale and bias in float32 and rounds
its output to the dtype. ``LayerNorm`` below does the same. Two ways to
get the dtype:

- ``cast_for_compute`` casts a module's weights once, in place, leaving the
  LayerNorms and the CMVN constants in float32: for inference;
- ``cast_at_use`` keeps every parameter float32 and has ``Linear``,
  ``Conv1d``, ``Conv2d``, ``Embedding``, ``LSTM`` and ``GRU`` cast their
  weights and input to the dtype at each call, as flax does: for training,
  where the master weights and their gradients must stay float32. It is
  not ``torch.autocast``, whose op lists are not flax's rule.

``Dropout`` is the JAX package's: the keep probability is quantized to
q/256, the mask drawn from 8-bit random integers of the generator the
caller sets (``dropout_generator``), and kept values divided by q/256.

``BatchNorm`` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over
the last axis: in ``train()`` mode it normalizes by the batch's mean and
biased variance over every other axis and moves the running statistics
by 0.1 towards them; in ``eval()`` mode it uses the running statistics.
Statistics, parameters and the arithmetic are float32, as for LayerNorm.
Under a process group of more than one rank, training mode takes the
moments of the global batch: the sums, sums of squares and counts of the
ranks of ``stats_group`` (the world, or a grid's data group) are
all-reduced, with a backward that all-reduces their gradients.

``init_parameters`` draws a fresh model from the JAX model's distributions:
Kaiming uniform (fan in, gain 2) for Dense and Conv kernels, times
``init_scale`` on the output projection of every encoder residual branch
(``scaled_kaiming``, the depth-scaled init (2·num_blocks)^-1/2), zero
biases, N(0, 1) embeddings, Xavier uniform ``pos_bias_u/v``, unit
LayerNorms and BatchNorms; U(−b, b) kernels and biases where a layer sets
``init_bound`` b (``symmetric_uniform``, the Squeezeformer's scale-aware
init), ``ada_scale`` 1 and ``ada_bias`` 0; for ``nn.LSTM`` and ``nn.GRU``
the flax cells' LeCun normal (truncated at two deviations) input kernels,
orthogonal recurrent kernels per gate and zero biases. Same distributions,
not the same bits."""
import contextlib
import json
import math
import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.parallel.distributed import (all_reduce_sum_with_grad,
                                                  world_size)


def swish(x):
    return x * torch.sigmoid(x)


def get_activation(name: str):
    """Activation registry; flax's ``gelu`` is the tanh approximation."""
    acts = {
        "hardtanh": F.hardtanh,
        "tanh": torch.tanh,
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate='tanh'),
        "swish": swish,
    }
    if name not in acts:
        raise ValueError(f"unsupported activation: {name}")
    return acts[name]


def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp.asarray(value, dtype)``
    rounds a constant before it multiplies a tensor of that dtype."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32 with float32 parameters, the
    result in the input's dtype (flax ``LayerNorm(dtype=...)``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis
    (see the module docstring): ``weight``/``bias`` are flax's
    ``scale``/``bias``, the ``running_mean``/``running_var`` buffers its
    ``batch_stats`` ``mean``/``var``. ``stats_group`` is the process group
    whose ranks hold the global batch (the world when None; the data group
    of a (data, model) grid, ``train_state.data_parallel``)."""
    stats_group = None

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def _batch_moments(self, xf):
        dims = tuple(range(xf.ndim - 1))
        if world_size(self.stats_group) > 1:
            # the global batch's moments, as GSPMD reduces them over the
            # sharded batch axis in JAX
            count = torch.full((1,), xf.numel() // xf.shape[-1],
                               dtype=xf.dtype, device=xf.device)
            sums = all_reduce_sum_with_grad(torch.cat(
                [xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]),
                self.stats_group)
            c = xf.shape[-1]
            mean = sums[:c] / sums[-1]
            return mean, sums[c:2 * c] / sums[-1] - mean * mean
        mean = xf.mean(dim=dims)
        return mean, (xf * xf).mean(dim=dims) - mean * mean

    def _update_running(self, mean, var):
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)

    def _running(self):
        return self.running_mean, self.running_var

    def _affine(self):
        return self.weight, self.bias

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean, var = self._batch_moments(xf)
            with torch.no_grad():
                self._update_running(mean.detach(), var.detach())
        else:
            mean, var = self._running()
        weight, bias = self._affine()
        y = (xf - mean) * torch.rsqrt(var + self.eps) * weight + bias
        return y.to(x.dtype)


class GlobalCMVN(nn.Module):
    """(x - mean) * istd with constants from ``mean_istd.json``; buffers,
    not parameters, and not part of the state dict."""

    def __init__(self, mean, istd):
        super().__init__()
        self.register_buffer('mean', torch.tensor(np.asarray(mean, np.float32)),
                             persistent=False)
        self.register_buffer('istd', torch.tensor(np.asarray(istd, np.float32)),
                             persistent=False)

    def forward(self, x):
        return (x - self.mean) * self.istd


def load_cmvn(mean_istd_path):
    """``mean_istd.json`` → (mean, istd) float32 tuples, as
    ppasr_tpu/models/factory.py:13-29 reads it. A missing file raises:
    a model trained with CMVN mis-predicts without it."""
    if not mean_istd_path:
        return None, None
    if not os.path.exists(mean_istd_path):
        raise FileNotFoundError(f"mean_istd file not found: {mean_istd_path}")
    with open(mean_istd_path, 'r', encoding='utf-8') as f:
        data = json.load(f)
    return (tuple(np.float32(v) for v in data['mean']),
            tuple(np.float32(v) for v in data['istd']))


class _CastAtUse:
    """Mixin: with ``compute_dtype`` set, ``forward`` runs on the weights
    and input cast to it (flax's ``promote_dtype`` of a Dense, Conv or
    Embed); ``init_scale`` scales the Kaiming init (``scaled_kaiming``)."""
    compute_dtype = None
    init_scale = 1.0
    init_bound = None

    def _weight(self):
        """The weight at use (a tensor-parallel layer gathers it here)."""
        return self.weight

    def _bias(self):
        return self.bias

    def _cast(self, x):
        weight, bias = self._weight(), self._bias()
        dt = self.compute_dtype
        if dt is None:
            return x, weight, bias
        return x.to(dt), weight.to(dt), None if bias is None else bias.to(dt)


class Linear(_CastAtUse, nn.Linear):
    def __init__(self, in_features, out_features, bias=True, init_scale=1.0,
                 init_bound=None):
        super().__init__(in_features, out_features, bias=bias)
        self.init_scale = init_scale
        self.init_bound = init_bound

    def forward(self, x):
        return F.linear(*self._cast(x))


class Conv1d(_CastAtUse, nn.Conv1d):
    def __init__(self, *args, init_bound=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.init_bound = init_bound

    def forward(self, x):
        return self._conv_forward(*self._cast(x))


class Conv2d(_CastAtUse, nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(*self._cast(x))


class Embedding(_CastAtUse, nn.Embedding):
    def forward(self, ids):
        weight = self._weight()
        if self.compute_dtype is not None:
            weight = weight.to(self.compute_dtype)
        return F.embedding(ids, weight)


class _CastAtUseRNN(_CastAtUse):
    """Mixin of a one-layer ``nn.LSTM`` or ``nn.GRU``: with
    ``compute_dtype`` set, ``forward`` runs on copies of the weights cast
    to it (flax's RNN cells with a ``dtype``), the float32 parameters
    behind them receiving the gradients. The input and the carry must be
    in that dtype already."""

    def forward(self, input, hx=None):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(input, hx)
        self._update_flat_weights()
        master = self._flat_weights
        self._flat_weights = [w if w is None else w.to(dt) for w in master]
        try:
            return super().forward(input, hx)
        finally:
            self._flat_weights = master


class LSTM(_CastAtUseRNN, nn.LSTM):
    pass


class GRU(_CastAtUseRNN, nn.GRU):
    pass


def compute_dtype_of(module: nn.Module) -> torch.dtype:
    """The dtype ``module`` (a ``Linear``, conv or ``Embedding``) computes
    in: its ``compute_dtype`` if set, else its weights'."""
    return module.compute_dtype or module.weight.dtype


class Dropout(nn.Module):
    """flax-style dropout of the JAX package (ppasr_tpu/models/base.py:
    73-100): active in ``train()`` mode; keep probability q/256 with
    q = round((1 − rate)·256) clipped to [1, 255]; the mask is
    ``bits < q`` for uint8 ``bits`` from ``self.generator`` (the default
    generator when None). ``sharded`` marks a dropout over activations
    that a tensor-parallel rank holds a shard of (attention heads, the FFN
    hidden): it draws from the step's sharded stream."""
    sharded = False

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        q = min(255, max(1, round((1.0 - self.rate) * 256)))
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             device=x.device, generator=self.generator)
        return torch.where(bits < q, x / (q / 256.0), 0.0).to(x.dtype)


@contextlib.contextmanager
def dropout_generator(module: nn.Module, generator, sharded=None):
    """Every ``Dropout`` of ``module`` draws from ``generator`` inside the
    block (the ``'dropout'`` stream of a train step), a ``sharded`` one
    from ``sharded`` where given (the ``'dropout_sharded'`` stream of a
    tensor-parallel step)."""
    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = sharded if m.sharded and sharded is not None \
            else generator
    try:
        yield
    finally:
        for m in drops:
            m.generator = None


def _uniform_(t, bound, generator):
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator, dtype=torch.float64)
                .mul_(2 * bound).sub_(bound).to(t.dtype))


def _lecun_normal_(t, generator):
    """flax's ``lecun_normal``: truncated normal at ±2 deviations, scaled so
    the variance is 1 / fan_in, for a torch [out, in] weight."""
    std = math.sqrt(1.0 / t.shape[1]) / .87962566103423978
    with torch.no_grad():
        x = torch.empty(t.shape, dtype=torch.float64)
        nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.copy_((x * std).to(t.dtype))


def _init_rnn(m, generator):
    """flax ``OptimizedLSTMCell`` / ``GRUCell`` initializers on the gate
    blocks of a single-layer ``nn.LSTM`` or ``nn.GRU``."""
    h = m.hidden_size
    with torch.no_grad():
        for w in m.weight_ih_l0.split(h):
            _lecun_normal_(w, generator)
        for w in m.weight_hh_l0.split(h):
            q = torch.empty(h, h, dtype=torch.float64)
            nn.init.orthogonal_(q, generator=generator)
            w.copy_(q.to(w.dtype))
        nn.init.zeros_(m.bias_ih_l0)
        nn.init.zeros_(m.bias_hh_l0)


def init_parameters(module: nn.Module, generator: torch.Generator = None):
    """Fresh parameters from the JAX model's initializers (see the module
    docstring), drawn on the CPU from ``generator``."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv1d, Conv2d)) and m.init_bound:
            _uniform_(m.weight, m.init_bound, generator)
            if m.bias is not None:
                _uniform_(m.bias, m.init_bound, generator)
        elif isinstance(m, (Linear, Conv1d, Conv2d)):
            fan_in = m.weight[0].numel()
            _uniform_(m.weight, math.sqrt(6.0 * m.init_scale ** 2 / fan_in),
                      generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LSTM, nn.GRU)):
            _init_rnn(m, generator)
        elif isinstance(m, BatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, Embedding):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator))
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        for name in ('pos_bias_u', 'pos_bias_v'):
            p = getattr(m, name, None)
            if isinstance(p, nn.Parameter):
                _uniform_(p, math.sqrt(6.0 / sum(p.shape)), generator)
        if isinstance(getattr(m, 'ada_scale', None), nn.Parameter):
            nn.init.ones_(m.ada_scale)
            nn.init.zeros_(m.ada_bias)
    return module


def cast_at_use(module: nn.Module, dtype: torch.dtype):
    """Compute in ``dtype`` over float32 parameters (see the module
    docstring); ``None`` computes in the weights' dtype again."""
    for m in module.modules():
        if isinstance(m, _CastAtUse):
            m.compute_dtype = None if dtype == torch.float32 else dtype
    return module


def cast_for_compute(module: nn.Module, dtype: torch.dtype):
    """Cast the floating parameters and buffers of every submodule to
    ``dtype`` in place, except those of ``LayerNorm``, ``BatchNorm`` and
    ``GlobalCMVN``, which stay float32 as flax keeps them."""
    for m in module.modules():
        if isinstance(m, (LayerNorm, BatchNorm, GlobalCMVN)):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
        for name, b in m.named_buffers(recurse=False):
            if b.is_floating_point():
                setattr(m, name, b.to(dtype))
    return module


class ASRModel(nn.Module):
    """What every model family shares: its compute dtype and its fresh
    initialization."""
    output_factor = 1      # time reduction after the input layer
    ring_cache = True      # a streaming step over ring caches of history

    def set_compute_dtype(self, dtype: torch.dtype, at_use: bool = False):
        """Run in ``dtype`` from now on (the JAX model's ``dtype``): the
        weights cast once, or with ``at_use`` kept float32 and cast at each
        call."""
        if at_use:
            cast_at_use(self, dtype)
        else:
            cast_for_compute(self, dtype)
        return self

    def init_weights(self, generator: torch.Generator = None):
        """Fresh parameters from the JAX model's initializers
        (``init_parameters``)."""
        return init_parameters(self, generator)
