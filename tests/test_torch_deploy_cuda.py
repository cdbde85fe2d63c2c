"""The deployment path on the card (the ``gpu`` marker; each test skips
itself without a card). No JAX here:

    python -m pytest --noconftest -m gpu tests/test_torch_deploy_cuda.py

- the ``ppasr_tpu_torch::rnn`` operator (``ops/rnn``, DeepSpeech2's RNNs
  in the exported programs) against ``nn.LSTM``/``nn.GRU`` on the card
  under ``ieee_float32``, at 1e-5;
- the card programs of each family (``infer_utils/torch_export``, small
  widths, make_torch_zoo_fixture's seeded weights) served by
  ``InferencePredictor(use_gpu=True)`` against its model code on the card
  within make_torch_deploy_fixture.PROGRAM_TOL, offline and over chunks
  (DeepSpeech2's programs against its model code run unpacked, as the
  programs run it, and against the packed run within DS2_PACKED_TOL);
- ``VADModel`` on the card with the fixture's seeded weights against the
  JAX probabilities of tests/fixtures/torch_deploy.npz within VAD_TOL.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from ppasr_tpu_torch.infer_utils.inference_predictor import InferencePredictor
from ppasr_tpu_torch.infer_utils.torch_export import export_programs
from ppasr_tpu_torch.infer_utils.vad_predictor import VADModel
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.ops.rnn import run_rnn
from ppasr_tpu_torch.utils.checkpoint import export_params, save_msgpack
from ppasr_tpu_torch.utils.precision import ieee_float32

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_deploy_fixture as dfx  # noqa: E402
import make_torch_zoo_fixture as zf  # noqa: E402

SMALL = {
    'conformer': (dict(output_size=64, attention_heads=4, linear_units=128,
                       num_blocks=2, cnn_module_kernel=15), {}),
    'squeezeformer': (dict(encoder_dim=64, output_size=64,
                           attention_heads=2, num_blocks=4, reduce_idx=1,
                           recover_idx=3, feed_forward_expansion_factor=2,
                           cnn_module_kernel=7), {}),
    'efficient_conformer': (dict(output_size=64, attention_heads=2,
                                 linear_units=128, num_blocks=3,
                                 cnn_module_kernel=15,
                                 efficient_conf=dict(
                                     stride_layer_idx=[1], stride=[2],
                                     group_layer_idx=[0, 1], group_size=3)),
                            {}),
    'deepspeech2': (dict(num_rnn_layers=2, rnn_size=64), {}),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the deployment path's card checks need a card")
    return torch.device('cuda:0')


@pytest.mark.gpu
@pytest.mark.parametrize('cell', [torch.nn.LSTM, torch.nn.GRU])
def test_rnn_operator_matches_the_module_on_the_card(cell):
    dev = _card()
    torch.manual_seed(0)
    rnn = cell(48, 64, batch_first=True).to(dev)
    x = torch.randn(3, 50, 48, device=dev)
    with torch.no_grad(), ieee_float32():
        want_y, want_carry = rnn(x)
        got_y, got_carry = run_rnn(rnn, x)
    assert (got_y - want_y).abs().max().item() < 1e-5
    for a, b in zip(torch.utils._pytree.tree_leaves(got_carry),
                    torch.utils._pytree.tree_leaves(want_carry)):
        assert (a - b).abs().max().item() < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize('use_model', sorted(SMALL))
def test_card_programs_match_the_model_code(use_model, tmp_path):
    dev = _card()
    enc, model_conf = SMALL[use_model]
    model = build_model(use_model, 80, 30, streaming=True, encoder_conf=enc,
                        model_conf=model_conf)
    zf.fill_weights(model, 5)
    save_msgpack(str(tmp_path / 'model.msgpack'), export_params(model))
    with open(tmp_path / 'inference.json', 'w', encoding='utf-8') as f:
        json.dump({'use_model': use_model, 'streaming': True,
                   'input_dim': 80, 'vocab_size': 30, 'encoder_conf': enc,
                   'model_conf': model_conf}, f)
    code = InferencePredictor(str(tmp_path), use_gpu=True,
                              use_stablehlo=False)
    assert next(code.model.parameters()).device == dev
    export_programs(code.model, str(tmp_path), use_model, 80)
    assert {'offline.pt2', 'offline.cuda.pt2'} <= set(os.listdir(tmp_path))
    prog = InferencePredictor(str(tmp_path), use_gpu=True)
    assert prog.stablehlo and prog.params[next(iter(prog.params))].is_cuda
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 96, 80)).astype(np.float32)
    lens = np.array([96, 70])
    ds2 = use_model == 'deepspeech2'
    p1, l1 = prog.predict(x, lens)
    p2, l2 = code.predict(x, lens)
    np.testing.assert_array_equal(l1, l2)
    for i, n in enumerate(l1):
        assert np.abs(p1[i, :n] - p2[i, :n]).max() < (
            dfx.DS2_PACKED_TOL if ds2 else dfx.PROGRAM_TOL)
    packed = InferencePredictor(str(tmp_path), use_gpu=True,
                                use_stablehlo=False) if ds2 else None
    if ds2:         # the program's arithmetic: the RNNs unpacked
        code.model.encoder.unpacked = True
    try:
        if ds2:
            p2, _ = code.predict(x, lens)
            for i, n in enumerate(l1):
                assert np.abs(p1[i, :n] - p2[i, :n]).max() < dfx.PROGRAM_TOL
        for _ in range(3):
            w = rng.standard_normal((1, 67, 80)).astype(np.float32)
            c1, c2 = ((p.predict_chunk_deepspeech(w) if ds2
                       else p.predict_chunk_conformer(w))
                      for p in (prog, code))
            assert np.abs(c1 - c2).max() < dfx.PROGRAM_TOL
            if ds2:
                c3 = packed.predict_chunk_deepspeech(w)
                assert np.abs(c1 - c3).max() < dfx.DS2_PACKED_TOL
    finally:
        if ds2:
            del code.model.encoder.unpacked


@pytest.mark.gpu
def test_vad_model_on_the_card_matches_jax(tmp_path):
    _card()
    data = np.load(dfx.OUT)
    d = dfx.write_vad_model(str(tmp_path), save_msgpack,
                            int(data['vad_seed']))
    model = VADModel(d, device='cuda:0')
    assert all(p.is_cuda for p in model.net.parameters())
    first, second = dfx.vad_windows(int(data['vad_windows_seed']))
    got = np.concatenate([model(first), model(second)])
    assert np.abs(got - data['jax_vad_probs']).max() < dfx.VAD_TOL
