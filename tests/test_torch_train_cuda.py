"""The training path on the card (the ``gpu`` marker; each test skips
itself without a card). No JAX here, so it runs where only the port's
packages are:

    python -m pytest --noconftest -m gpu tests/test_torch_train_cuda.py

- kernel B1 with the training dither, at the training launch shape
  (``fbank_batch`` over a [32, 128,000]-sample batch, noise [32, 798,
  400]), against its plain version given the same noise: mean |Δ| < 1e-3
  and max |Δ| < 0.05 log-mel, B1's tolerance (tests/test_torch_fbank.py);
- B1 without noise is bit-identical to B1 with all-zero noise (x + 0 = x),
  and every row of the batch launch to the same row's own window launch;
- the CTC loss and its gradient on the card against the CPU: 1e-5
  relative on the value, 1e-5 absolute on the gradient (float32 sums in
  another order);
- one full-width train step (the committed flagship, the training
  fixture's 8 utterances, accum_grad 2, float32 under ``ieee_float32``) on
  the card against the same step on the CPU: the metrics within
  make_torch_train_fixture.F32_RTOL; each parameter's change within 2·lr
  of the CPU's (Adam's first update is lr·g/(|g| + eps), so a gradient
  near 0 may take either sign) and within 1 % of lr for 99 % of them.
"""
import os
import sys

import numpy as np
import pytest
import torch

from ppasr_tpu_torch.ops import ctc
from ppasr_tpu_torch.ops import fbank as F
from ppasr_tpu_torch.ops import fbank_cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_train_fixture as tf  # noqa: E402
from make_torch_smoke_fixture import speechlike  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA C++ and has no CPU mode; needs a card")
    return torch.device('cuda:0')


def _close(a, b):
    d = (a.double().cpu() - b.double().cpu()).abs()
    assert d.mean().item() < 1e-3 and d.max().item() < 0.05, (
        d.mean().item(), d.max().item())


def _train_batch(dev, bsz=32, s=128000):
    """[bsz, s] speech-like rows whose last second is silent, as the
    padding of a real batch is."""
    rows = np.stack([speechlike(s, seed=300 + i) for i in range(bsz)])
    rows[:, -16000:] = 0.0
    lens = np.full(bsz, s) - np.arange(bsz) * 1600
    wav = torch.from_numpy(rows).to(dev)
    return wav, torch.from_numpy(lens).to(dev)


@pytest.mark.gpu
def test_dithered_batch_launch_matches_plain_version():
    dev = _card()
    wav, lens = _train_batch(dev)
    t = wav.shape[1] // 160 - 2
    gen = torch.Generator(dev).manual_seed(0)
    noise = torch.randn((wav.shape[0], t, 400), generator=gen, device=dev)
    before = fbank_cuda.launches
    got, got_lens = fbank_cuda.fbank_batch(wav, lens, noise=noise)
    torch.cuda.synchronize()
    assert fbank_cuda.launches == before + 1
    plain, plain_lens = F.fbank_batch_torch(wav, lens, noise=noise)
    assert torch.equal(got_lens.cpu(), plain_lens.cpu())
    _close(got, plain)
    clean, _ = fbank_cuda.fbank_batch(wav, lens)
    # the dither shows in the silent frames (log-mel at its floor without)
    assert (got - clean)[:, -90:].abs().mean().item() > 1.0


@pytest.mark.gpu
def test_undithered_launch_is_bit_identical():
    dev = _card()
    wav, lens = _train_batch(dev, bsz=4, s=32000)
    t = wav.shape[1] // 160 - 2
    clean, _ = fbank_cuda.fbank_batch(wav, lens)
    zeros, _ = fbank_cuda.fbank_batch(
        wav, lens, noise=torch.zeros((4, t, 400), device=dev))
    assert torch.equal(clean, zeros)
    for b in range(4):
        row = fbank_cuda.fbank_window(wav[b].contiguous(), t)
        assert torch.equal(clean[b], row)


@pytest.mark.gpu
def test_ctc_loss_on_card_matches_cpu():
    dev = _card()
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((8, 200, 425)).astype(np.float32) * 3
    labels = rng.integers(1, 425, (8, 40)).astype(np.int32)
    ll = rng.integers(0, 41, 8)
    labels[np.arange(40)[None, :] >= ll[:, None]] = -1
    il = rng.integers(100, 201, 8)
    out = []
    for d in ('cpu', dev):
        x = torch.tensor(logits, device=d, requires_grad=True)
        loss = ctc.ctc_loss_from_logits(x, torch.tensor(il, device=d),
                                        torch.tensor(labels, device=d),
                                        torch.tensor(ll, device=d))
        loss.backward()
        out.append((loss.item(), x.grad.cpu()))
    assert abs(out[1][0] - out[0][0]) <= 1e-5 * abs(out[0][0])
    assert (out[1][1] - out[0][1]).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_full_width_train_step_on_card_matches_cpu():
    dev = _card()
    from test_torch_flagship_train import flagship
    from ppasr_tpu_torch.config import load_config
    from ppasr_tpu_torch.ops.frontend import make_device_frontend
    from ppasr_tpu_torch.train_state import create_train_state, \
        make_train_step
    data = tf.load()
    conf = load_config(tf.CONFIG)
    arrays = tf.micro_batches(tf.batch(data))
    runs = []
    for d in ('cpu', dev):
        model = flagship().to(d)
        state = create_train_state(model, dict(conf.optimizer_conf), 5.0)
        step = make_train_step(tf.ACCUM, make_device_frontend({'n_mels': 80}),
                               deterministic=True)
        batch = {k: torch.from_numpy(np.ascontiguousarray(a)).to(d)
                 for k, a in zip(('wav', 'wav_lens', 'text', 'text_lens'),
                                 arrays)}
        metrics = step(state, batch, 0)
        runs.append(({k: v.item() for k, v in metrics.items()},
                     {n: p.detach().cpu() for n, p in
                      model.named_parameters()}))
    start = dict(flagship().named_parameters())
    lr = state.schedule(0)
    for k, v in runs[0][0].items():
        assert abs(runs[1][0][k] - v) <= tf.F32_RTOL * max(abs(v), 1e-6), k
    far, total = 0, 0
    for n, p in runs[0][1].items():
        p0 = start[n].detach()
        diff = ((runs[1][1][n] - p0) - (p - p0)).abs()
        assert diff.max().item() <= 2 * lr * (1 + 1e-3), n
        far += int((diff > 0.01 * lr).sum())
        total += diff.numel()
    assert far <= 0.01 * total, (far, total)
