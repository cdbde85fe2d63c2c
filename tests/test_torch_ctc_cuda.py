"""Kernel C1, the CTC lattice (ppasr_tpu_torch/csrc/ctc.cu), against its
plain version on the card: the loss and its gradient with respect to the
logits through ``ctc_loss_from_logits``, once with the kernels and once
with the plain ``ctc.lattice_alpha`` and autograd's gradient through it in
their place on the same CUDA tensors (``torch_ctc_cases.loss_and_grad``).
CUDA C++ has no CPU mode, so these tests skip without a card. The file
imports no JAX, so it also runs on a machine that has only the port's
packages:

    python -m pytest --noconftest -m gpu tests/test_torch_ctc_cuda.py

Tolerances, kernel against plain on the card: 1e-6 relative on the loss
and 1e-6 absolute on the gradient (entries up to 1/B). The kernels repeat
the loop's float32 operations and the partials autograd gives
``logaddexp``, with the same CUDA math functions; what is left is the
order in which the partials that reach one lattice cell are added, and
that of the atomic adds of the emissions' scatter into the logits'
gradient, where many extended labels share the blank.
Against the CPU: 1e-5 and 1e-5, as tests/test_torch_train_cuda.py (float32
libm and sums that differ between the host and the card). bf16 logits:
the gradient comes back in bf16, so one bf16 step (2^-7 relative).
"""
import os
import sys

import numpy as np
import pytest
import torch

from ppasr_tpu_torch.ops import ctc, ctc_cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ctc_cases as cc  # noqa: E402

LOSS_RTOL, GRAD_ATOL = 1e-6, 1e-6
CPU_TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("kernel C1 is CUDA C++ and has no CPU mode; needs a card")
    return torch.device('cuda:0')


def _kernel_and_plain(*args, **kw):
    torch.cuda.synchronize()
    before = ctc_cuda.launches
    kernel = cc.loss_and_grad(*args, **kw)
    torch.cuda.synchronize()
    assert ctc_cuda.launches == before + 2
    plain = cc.loss_and_grad(*args, plain=True, **kw)
    assert ctc_cuda.launches == before + 2
    return kernel, plain


def _close(kernel, plain, loss_rtol=LOSS_RTOL, grad_atol=GRAD_ATOL):
    (kl, kg), (pl, pg) = kernel, plain
    assert torch.isfinite(kl).all() and torch.isfinite(kg).all()
    torch.testing.assert_close(kl, pl, rtol=loss_rtol, atol=0)
    torch.testing.assert_close(kg.float(), pg.float(), rtol=0,
                               atol=grad_atol)


def _tensors(dev, logits, labels, ll, il):
    return (torch.tensor(logits, device=dev), torch.tensor(il, device=dev),
            torch.tensor(labels, device=dev), torch.tensor(ll, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize('case', list(cc.CASES))
def test_cpu_cases_on_card(case):
    """The four CPU cases: kernel against plain on the card and on the
    host; 'mixed' also per utterance, with a gradient of stride 1."""
    dev = _card()
    args = _tensors(dev, *cc.inputs(case))
    kernel, plain = _kernel_and_plain(*args)
    _close(kernel, plain)
    host = cc.loss_and_grad(*(a.cpu() for a in args))
    assert abs(kernel[0].item() - host[0].item()) <= \
        CPU_TOL * abs(host[0].item())
    assert (kernel[1].cpu() - host[1]).abs().max().item() <= CPU_TOL
    if case == 'mixed':
        w = torch.tensor([0.5, 2.0, -1.0], device=dev)
        _close(*_kernel_and_plain(*args, average_batch=False,
                                  weights=w))


@pytest.mark.gpu
@pytest.mark.parametrize('max_t', [318, 398])
def test_cell_shapes(max_t):
    dev = _card()
    _close(*_kernel_and_plain(*_tensors(dev, *cc.cell_batch(max_t,
                                                             seed=max_t))))


@pytest.mark.gpu
def test_unfit_rows_finite_and_equal_to_plain():
    """Rows whose labels do not fit their frames: loss about 1e30 / B,
    finite, and the gradient the plain version's (autograd's through the
    loop)."""
    dev = _card()
    args = _tensors(dev, *cc.inputs('unfit'))
    kernel, plain = _kernel_and_plain(*args)
    assert kernel[0].item() >= 1e29
    _close(kernel, plain)


@pytest.mark.gpu
def test_empty_labels_and_one_frame():
    """U = 0 (S = 1 over the whole batch and beside labelled rows), input
    length 1, and a one-frame batch."""
    dev = _card()
    rng = np.random.default_rng(7)
    p = cc.P
    for labels, ll, il, max_t in (
            ([[p], [p], [p]], [0, 0, 0], [1, 5, 3], 5),
            ([[p, p], [4, p], [2, 2]], [0, 1, 2], [1, 1, 6], 6),
            ([[3], [p]], [1, 0], [1, 1], 1)):
        logits = rng.standard_normal((len(ll), max_t, 7)).astype(np.float32)
        labels = np.asarray(labels, np.int32).reshape(len(ll), -1)
        _close(*_kernel_and_plain(*_tensors(
            dev, logits, labels, np.asarray(ll), np.asarray(il))))


@pytest.mark.gpu
@pytest.mark.parametrize('max_u,max_t', [(600, 1300), (3000, 6100)])
def test_label_axis_wider_than_a_block(max_u, max_t):
    """S = 1,201 (two values of s a thread at 1,024 threads) and S = 6,001
    (eight, and the backward's 96 KB of shared memory past the default
    48 KB)."""
    dev = _card()
    rng = np.random.default_rng(max_u)
    labels = rng.integers(1, 64, (2, max_u)).astype(np.int32)
    ll = np.asarray([max_u, max_u - 7])
    labels[1, -7:] = -1
    il = np.asarray([max_t, max_t - 50])
    logits = rng.standard_normal((2, max_t, 64)).astype(np.float32)
    _close(*_kernel_and_plain(*_tensors(dev, logits, labels,
                                                     ll, il)))


@pytest.mark.gpu
def test_past_the_shared_memory_limit_raises():
    dev = _card()
    u = ctc_cuda.MAX_S // 2 + 1
    labels = torch.ones((1, u), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=str(ctc_cuda.MAX_S)):
        ctc.ctc_loss_from_logits(torch.zeros((1, 2, 5), device=dev),
                                 torch.tensor([2], device=dev), labels,
                                 torch.tensor([u], device=dev))


@pytest.mark.gpu
def test_bf16_logits():
    dev = _card()
    logits, il, labels, ll = _tensors(dev, *cc.cell_batch(318, seed=5))
    kernel, plain = _kernel_and_plain(logits.bfloat16(), il, labels, ll)
    assert kernel[1].dtype == torch.bfloat16
    torch.testing.assert_close(kernel[0], plain[0], rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(kernel[1].float(), plain[1].float(),
                               rtol=2 ** -7, atol=GRAD_ATOL)


@pytest.mark.gpu
def test_launches_and_alpha_kept_only_for_a_gradient(monkeypatch):
    """Forward and backward: 2 launches; under ``no_grad`` or on logits
    that need no gradient: 1, without the alpha scratch."""
    dev = _card()
    logits, il, labels, ll = _tensors(dev, *cc.inputs('mixed'))
    kept = []
    launch = ctc_cuda.lattice_alpha

    def spy(*args):
        kept.append(args[-1])
        return launch(*args)
    monkeypatch.setattr(ctc_cuda, 'lattice_alpha', spy)
    before = ctc_cuda.launches
    loss, _ = cc.loss_and_grad(logits, il, labels, ll)
    assert ctc_cuda.launches == before + 2
    with torch.no_grad():
        quiet = ctc.ctc_loss_from_logits(logits.requires_grad_(), il,
                                         labels, ll)
    assert ctc_cuda.launches == before + 3
    ctc.ctc_loss_from_logits(logits.detach(), il, labels, ll)
    assert ctc_cuda.launches == before + 4
    assert kept == [True, False, False]
    assert quiet.item() == loss.item()
