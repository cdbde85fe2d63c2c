"""``compute_dtype='bfloat16'`` on the card against the same predictor on
the CPU, with the committed flagship (pinned to the JAX package's bf16 by
tests/test_torch_{bf16,flagship}.py). The test skips without a card; the
file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bf16_cuda.py

Tolerances: the CTC log-probs within ``BF16_LOGPROB_TOL`` (1.0) of the
CPU's, with a mean |Δ| below 0.1 (bf16 rounding in cuBLAS's and the CPU's
orders; tests/test_torch_bf16.py); the streaming state in bf16 on the
card."""
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from ppasr_tpu_torch.predict import PPASRPredictor, ieee_float32

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402


@pytest.mark.gpu
def test_bf16_log_probs_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("bf16 is checked here on a card; its CPU path is tested "
                    "against JAX elsewhere")
    data = np.load(fx.OUT)
    pcms = np.split(data['pcm'], np.cumsum(data['lengths'])[:-1])
    with tempfile.TemporaryDirectory() as tmp:
        artifact = fx.flagship_artifact(tmp)
        cpu = PPASRPredictor(model_path=artifact, use_gpu=False,
                             compute_dtype='bfloat16')
        card = PPASRPredictor(model_path=artifact, use_gpu=True,
                              compute_dtype='bfloat16')
    x, lens = fx.host_features(cpu, pcms)
    with torch.inference_mode(), ieee_float32():
        want, olens = cpu.model.get_ctc_log_probs(torch.from_numpy(x),
                                                  torch.from_numpy(lens))
        got, _ = card.model.get_ctc_log_probs(
            torch.from_numpy(x).to(card.device),
            torch.from_numpy(lens).to(card.device))
        state = card.model.init_state(1, 16, card.device)
    valid = torch.arange(want.shape[1])[None, :] < olens[:, None]
    d = (got.cpu() - want).abs()[valid]
    assert d.max().item() <= fx.BF16_LOGPROB_TOL and d.mean().item() < 0.1
    assert state.att_k.dtype == torch.bfloat16 and state.att_k.is_cuda
