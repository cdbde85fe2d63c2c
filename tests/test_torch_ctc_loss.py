"""The port's CTC loss (ppasr_tpu_torch/ops/ctc.py) against the JAX
package's (ppasr_tpu/ops/ctc.py) and against ``F.ctc_loss(reduction='sum')
/ B``, value and gradient with respect to the logits, on the CPU.

Cases (tests/torch_ctc_cases.py): mixed lengths, U = 0, a repeated label
(the skip transition is closed), input length exactly 2U + 1 where the
labels repeat, and bf16 logits. Tolerances: float32 values within 1e-5
relative and gradients within 1e-5 absolute (the same log-semiring sums in
another order); bf16 logits against the float32 loss of the same rounded
logits, exact to the same 1e-5, since both compute in float32 from the
bf16 values.

On the CPU the loss runs the plain ``lattice_alpha`` with autograd's
gradient, whose arithmetic kernel C1 repeats (tests/test_torch_ctc_cuda.py
holds the kernels to it on the card); rows whose labels do not fit their
frames, where ``F.ctc_loss`` reads inf, read 1e30 with a finite
gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ppasr_tpu.ops import ctc as jax_ctc
import torch_ctc_cases as cc
from ppasr_tpu_torch.ops import ctc, ctc_cuda
from torch_train_util import one_torch_thread  # noqa: F401

TOL = 1e-5
CASES = cc.CASES
_inputs = cc.inputs


@jax.jit
def _jax_from_logits(x, il, labels, ll):
    return jax.value_and_grad(jax_ctc.ctc_loss_from_logits)(x, il, labels, ll)


@jax.jit
def _jax_from_log_probs(x, il, labels, ll):
    return jax.value_and_grad(lambda y: jax_ctc.ctc_loss(
        jax.nn.log_softmax(y, -1), il, labels, ll))(x)


def _port(logits, labels, ll, il, from_logits=True):
    x = torch.tensor(logits, requires_grad=True)
    args = (torch.tensor(il), torch.tensor(labels), torch.tensor(ll))
    loss = ctc.ctc_loss_from_logits(x, *args) if from_logits else \
        ctc.ctc_loss(torch.log_softmax(x, -1), *args)
    loss.backward()
    return loss.item(), x.grad.numpy()


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('from_logits', [True, False])
def test_matches_jax(case, from_logits):
    logits, labels, ll, il = _inputs(case)
    fn = _jax_from_logits if from_logits else _jax_from_log_probs
    jl, jg = fn(jnp.asarray(logits), jnp.asarray(il), jnp.asarray(labels),
                jnp.asarray(ll))
    tl, tg = _port(logits, labels, ll, il, from_logits)
    assert abs(tl - float(jl)) <= TOL * abs(float(jl))
    assert np.abs(tg - np.asarray(jg)).max() <= TOL


@pytest.mark.parametrize('case', list(CASES))
def test_matches_torch_ctc_loss(case):
    logits, labels, ll, il = _inputs(case, seed=1)
    x = torch.tensor(logits, requires_grad=True)
    ref = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1),
                     torch.tensor(np.where(labels < 0, 0, labels)),
                     torch.tensor(il), torch.tensor(ll),
                     reduction='sum') / len(ll)
    ref.backward()
    tl, tg = _port(logits, labels, ll, il)
    assert abs(tl - ref.item()) <= TOL * abs(ref.item())
    assert np.abs(tg - x.grad.numpy()).max() <= TOL


def test_per_utterance_and_frozen_rows():
    """average_batch=False gives each row's NLL; frames past a row's input
    length do not change it."""
    logits, labels, ll, il = _inputs('mixed')
    args = (torch.tensor(il), torch.tensor(labels), torch.tensor(ll))
    nll = ctc.ctc_loss_from_logits(torch.tensor(logits), *args,
                                   average_batch=False)
    noisy = logits.copy()
    for b, n in enumerate(il):
        noisy[b, n:] = 50.0
    nll2 = ctc.ctc_loss_from_logits(torch.tensor(noisy), *args,
                                    average_batch=False)
    torch.testing.assert_close(nll, nll2, rtol=0, atol=0)
    assert abs(nll.sum().item() / 3 - ctc.ctc_loss_from_logits(
        torch.tensor(logits), *args).item()) <= 1e-5


def test_bf16_logits():
    """bf16 logits: the loss and gradient of the float32 path on the same
    rounded logits; the gradient comes back in bf16."""
    logits, labels, ll, il = _inputs('mixed', seed=2)
    xb = torch.tensor(logits).to(torch.bfloat16).requires_grad_()
    args = (torch.tensor(il), torch.tensor(labels), torch.tensor(ll))
    lb = ctc.ctc_loss_from_logits(xb, *args)
    lb.backward()
    assert xb.grad.dtype == torch.bfloat16
    tl, tg = _port(xb.detach().float().numpy(), labels, ll, il)
    assert abs(lb.item() - tl) <= TOL * abs(tl)
    assert np.abs(xb.grad.float().numpy() - tg).max() <= 1e-2  # bf16 grad


@pytest.mark.parametrize('case', list(CASES) + ['unfit'])
def test_per_row_nll_and_finite_gradient(case):
    """average_batch=False: each row's NLL is ``F.ctc_loss``'s (reduction
    'none') where that is finite; a row whose labels do not fit its frames
    reads at least 1e29 (LOG_EPSILON's paths) where the library reads inf,
    and the gradient stays finite. The 'unfit' batch also holds a fitting
    row and one of input length 0, which the lattice reads as one frame."""
    logits, labels, ll, il = _inputs(case, seed=3)
    x = torch.tensor(logits, requires_grad=True)
    nll = ctc.ctc_loss_from_logits(x, torch.tensor(il), torch.tensor(labels),
                                   torch.tensor(ll), average_batch=False)
    nll.sum().backward()
    ref = F.ctc_loss(torch.log_softmax(x.detach(), -1).transpose(0, 1),
                     torch.tensor(np.where(labels < 0, 0, labels)),
                     torch.tensor(il), torch.tensor(ll), reduction='none')
    fit = torch.isfinite(ref)
    unfit = ~fit & torch.tensor(il > 0)
    assert torch.isfinite(x.grad).all()
    torch.testing.assert_close(nll.detach()[fit], ref[fit], rtol=TOL, atol=0)
    assert (nll.detach()[unfit] >= 1e29).all()
    assert unfit.sum().item() == (2 if case == 'unfit' else 0)


def test_cpu_launches_no_kernel_and_no_grad_gives_the_same_loss():
    """On the CPU the plain versions run (C1's ``launches`` stays 0);
    under ``no_grad`` the loss is the same to the bit."""
    logits, labels, ll, il = _inputs('mixed')
    args = (torch.tensor(il), torch.tensor(labels), torch.tensor(ll))
    before = ctc_cuda.launches
    x = torch.tensor(logits, requires_grad=True)
    loss = ctc.ctc_loss_from_logits(x, *args)
    loss.backward()
    with torch.no_grad():
        quiet = ctc.ctc_loss_from_logits(x, *args)
    assert ctc_cuda.launches == before == 0
    assert not quiet.requires_grad
    assert quiet.item() == loss.item()
