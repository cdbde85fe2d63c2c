"""The model zoo on the card (the ``gpu`` marker; each test skips itself
without a card). No JAX here:

    python -m pytest --noconftest -m gpu tests/test_torch_zoo_cuda.py

- each family at its committed config's full width with
  make_torch_zoo_fixture's seeded weights: the CTC log-probs of a ragged
  batch on the card, in float32 under ``ieee_float32``, against the same
  forward on the CPU within make_torch_zoo_fixture.LOGPROB_TOL, and the
  streaming step over three windows within the same;
- DeepSpeech2's ``nn.LSTM`` (cuDNN) under ``ieee_float32`` against the CPU
  at 1e-5 absolute, packed ragged rows and its final state included, and
  ``ieee_float32`` turning cuDNN's TF32 off for it; its backward in eval
  mode (the train step's deterministic mode; cuDNN runs an RNN's backward
  only in training mode, which the encoder keeps its RNNs in), each
  parameter's gradient as close to the float64 gradient as the CPU's
  float32 one (within twice its error);
- DeepSpeech2 with ``enable_amp`` (its LSTMs in bf16 over float32
  weights, cast at use) at full width: one deterministic step on B1's
  features of the training fixture's batch, loss terms and gradient norm
  against the JAX bf16 step of tests/fixtures/torch_recipe.npz within
  make_torch_train_fixture's bf16 tolerances.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from ppasr_tpu_torch.models import base
from ppasr_tpu_torch.models.deepspeech2 import CRNNEncoder
from ppasr_tpu_torch.predict import ieee_float32

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_train_fixture as tf  # noqa: E402
import make_torch_recipe_fixture as rf  # noqa: E402
import make_torch_zoo_fixture as zf  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the card checks of the model zoo need a card")
    return torch.device('cuda:0')


def _batch(seed=0, t_max=300, lens=(300, 211, 97)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lens), t_max, 80)).astype(np.float32)
    return torch.from_numpy(x), torch.tensor(lens)


@pytest.mark.gpu
@pytest.mark.parametrize('use_model', sorted(zf.FAMILIES))
def test_full_width_forward_matches_cpu(use_model):
    dev = _card()
    cpu, _ = zf.zoo_model(use_model)
    card, _ = zf.zoo_model(use_model)
    cpu.eval()
    card.to(dev).eval()
    x, lens = _batch()
    with torch.no_grad(), ieee_float32():
        want, want_lens = cpu.get_ctc_log_probs(x, lens)
        got, got_lens = card.get_ctc_log_probs(x.to(dev), lens.to(dev))
        assert torch.equal(got_lens.cpu(), want_lens)
        for b, n in enumerate(want_lens.tolist()):
            d = (got[b, :n].cpu() - want[b, :n]).abs().max().item()
            assert d < zf.LOGPROB_TOL, (b, d)
        ds2 = use_model == 'deepspeech2'
        s_cpu, s_card = cpu.init_state(2, 256), card.init_state(2, 256, dev)
        for k in range(3):
            xs = x[:2, k * 64:k * 64 + 67].contiguous()
            if ds2:
                n = torch.full((2,), 67)
                want, _, s_cpu = cpu.get_encoder_out_chunk(xs, n, s_cpu)
                got, _, s_card = card.get_encoder_out_chunk(
                    xs.to(dev), n.to(dev), s_card)
            else:
                want, s_cpu = cpu.get_encoder_out_chunk(xs, s_cpu)
                got, s_card = card.get_encoder_out_chunk(xs.to(dev), s_card)
            d = (got.cpu().log() - want.log()).abs().max().item()
            assert d < zf.LOGPROB_TOL, (k, d)


@pytest.mark.gpu
@pytest.mark.parametrize('use_gru', [False, True])
def test_ds2_rnn_under_ieee_float32(use_gru):
    dev = _card()
    torch.manual_seed(0)
    cpu = CRNNEncoder(80, num_rnn_layers=2, rnn_size=256, use_gru=use_gru,
                      bidirectional=True).eval()
    card = CRNNEncoder(80, num_rnn_layers=2, rnn_size=256, use_gru=use_gru,
                       bidirectional=True)
    card.load_state_dict(cpu.state_dict())
    card.to(dev).eval()
    x, lens = _batch(1)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad(), ieee_float32():
            assert not torch.backends.cudnn.allow_tf32
            want, want_lens, want_state = cpu(x, lens)
            got, got_lens, got_state = card(x.to(dev), lens.to(dev))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(got_lens.cpu(), want_lens)
    for b, n in enumerate(want_lens.tolist()):
        torch.testing.assert_close(got[b, :n].cpu(), want[b, :n], atol=1e-5,
                                   rtol=0)
    for g, w in zip(got_state, want_state):
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=0)


def _grads(model, x, lens, device, dtype):
    """{name: gradient in float64 on the CPU} of Σ out² through ``model``
    (a copy moved to ``device`` and ``dtype``) in eval mode."""
    m = copy.deepcopy(model).to(device, dtype).eval()
    out, _, _ = m(x.to(device, dtype), lens.to(device))
    (out.double() ** 2).sum().backward()
    return {n: p.grad.double().cpu() for n, p in m.named_parameters()
            if p.grad is not None}


@pytest.mark.gpu
@pytest.mark.parametrize('use_gru', [False, True])
def test_ds2_backward_in_eval_mode(use_gru, monkeypatch):
    """The float32 gradient of this random encoder is ill-conditioned (the
    CPU's float32 gradient is some 3e-3 from the float64 one, relative),
    so each parameter's gradient on the card must be as close to the
    float64 gradient as the CPU's float32 one is: within twice its error
    plus 1e-6, relative."""
    dev = _card()
    torch.manual_seed(1)
    model = CRNNEncoder(80, num_rnn_layers=2, rnn_size=128, use_gru=use_gru)
    x, lens = _batch(2, t_max=120, lens=(120, 77))
    with ieee_float32():
        card = _grads(model, x, lens, dev, torch.float32)
        cpu = _grads(model, x, lens, 'cpu', torch.float32)
    # the float64 reference: LayerNorm in the parameters' dtype
    monkeypatch.setattr(base.LayerNorm, 'forward', lambda self, v: F.layer_norm(
        v, self.normalized_shape, self.weight, self.bias, self.eps))
    exact = _grads(model, x.double(), lens, 'cpu', torch.float64)
    assert set(card) == set(cpu) == set(exact)
    for name, g in exact.items():
        err_card = (card[name] - g).norm().item()
        err_cpu = (cpu[name] - g).norm().item()
        assert err_card <= 2 * err_cpu + 1e-6 * g.norm().item(), \
            (name, err_card, err_cpu)


@pytest.mark.gpu
def test_ds2_bf16_step_matches_jax():
    from ppasr_tpu_torch.ops.frontend import make_device_frontend
    from ppasr_tpu_torch.train_state import (create_train_state,
                                             make_train_step)
    dev = _card()
    model, conf = zf.zoo_model('deepspeech2')
    model.to(dev).set_compute_dtype(torch.bfloat16, at_use=True)
    state = create_train_state(model, dict(conf.optimizer_conf),
                               float(conf.train_conf.grad_clip))
    batch = dict(zip(('wav', 'wav_lens', 'text', 'text_lens'),
                     [torch.from_numpy(a).to(dev)[None]
                      for a in tf.batch(tf.load())]))
    step = make_train_step(1, make_device_frontend({'n_mels': 80}),
                           deterministic=True)
    metrics = step(state, batch, 0)
    want = np.load(rf.OUT)
    for k, rtol in (('loss', tf.BF16_LOSS_RTOL),
                    ('loss_ctc', tf.BF16_LOSS_RTOL),
                    ('grad_norm', tf.BF16_GRAD_NORM_RTOL)):
        assert metrics[k].item() == pytest.approx(
            float(want[f'ds2_bf16_{k}']), rel=rtol), k
    assert all(p.dtype == torch.float32 for p in model.parameters())
