"""The port's label-smoothing KL loss (ppasr_tpu_torch/ops/
label_smoothing.py) and ``th_accuracy`` against the JAX package's, value
and gradient, on the CPU, normalized by B and by the token count, with
padded targets and an all-padding row. Tolerance: 1e-6 relative on the
value and 1e-6 absolute on the gradient (float32, the same sums in another
order); the accuracy is exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppasr_tpu.ops.common import th_accuracy as jax_th_accuracy
from ppasr_tpu.ops.label_smoothing import label_smoothing_loss as jax_ls
from ppasr_tpu_torch.ops.common import th_accuracy
from ppasr_tpu_torch.ops.label_smoothing import label_smoothing_loss
from torch_train_util import one_torch_thread  # noqa: F401


def _inputs(seed=0, b=3, u=5, v=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, u, v)).astype(np.float32) * 3
    targets = rng.integers(0, v, (b, u)).astype(np.int32)
    targets[1, 3:] = -1
    targets[2, :] = -1
    return logits, targets


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_loss_and_grad(logits, targets, smoothing, normalize_length):
    return jax.value_and_grad(lambda x: jax_ls(
        x, targets, smoothing, normalize_length))(logits)


@pytest.mark.parametrize('normalize_length', [False, True])
@pytest.mark.parametrize('smoothing', [0.0, 0.1])
def test_matches_jax(normalize_length, smoothing):
    logits, targets = _inputs()
    jl, jg = _jax_loss_and_grad(jnp.asarray(logits), jnp.asarray(targets),
                                smoothing, normalize_length)
    x = torch.tensor(logits, requires_grad=True)
    tl = label_smoothing_loss(x, torch.tensor(targets), smoothing,
                              normalize_length)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-6 * abs(float(jl))
    assert np.abs(x.grad.numpy() - np.asarray(jg)).max() <= 1e-6


def test_th_accuracy_matches_jax():
    logits, targets = _inputs(seed=1, v=3)     # few classes: some hits
    want = float(jax_th_accuracy(jnp.asarray(logits), jnp.asarray(targets)))
    got = th_accuracy(torch.tensor(logits), torch.tensor(targets))
    assert got.dtype == torch.float32
    assert 0.0 < want < 1.0
    assert got.item() == pytest.approx(want, abs=0)
