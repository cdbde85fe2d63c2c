"""The attention decoder's pass on the card against the same module on the
CPU, at the flagship's width: the committed checkpoint's 3 + 3-block
decoder (256-dim, 4 heads, 1,024 units, vocabulary 425) scoring 300
hypotheses of up to 200 tokens over 40 encoder frames, and a whole
rescoring pass (beam 300 with the synth trigram, then the decoder). The CPU
side is pinned to the JAX package by tests/test_torch_{transformer_decoder,
rescoring,flagship}.py. These tests skip without a card; the file imports
no JAX, so it runs on a machine with only the port's packages:

    python -m pytest --noconftest -m gpu tests/test_torch_rescoring_cuda.py

Tolerances: scores within 1e-3 absolute plus 1e-5 relative (sums over up
to 201 log-softmax terms of float32 logits through 6 decoder blocks, in
cuBLAS's and the CPU's orders, TF32 off); the rescored texts equal."""
import os
import sys

import numpy as np
import pytest
import torch

from ppasr_tpu_torch.decoders.rescoring import AttentionRescoringDecoder
from ppasr_tpu_torch.predict import ieee_float32
from ppasr_tpu_torch.utils.checkpoint import convert_params, load_msgpack

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_smoke_fixture as fx  # noqa: E402

ATOL, RTOL = 1e-3, 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the decoder is checked here on a card; its CPU path is "
                    "tested against JAX elsewhere")
    return torch.device('cuda:0')


def _flagship(device):
    from ppasr_tpu_torch.config import load_config
    from ppasr_tpu_torch.models.factory import build_model
    cfg = load_config(os.path.join(fx.ROOT, 'configs', 'campaign',
                                   'conformer_synth.yml'))
    model = build_model(cfg.use_model, 80, 425, streaming=cfg.streaming,
                        encoder_conf=cfg.encoder_conf,
                        decoder_conf=cfg.decoder_conf,
                        model_conf=cfg.model_conf,
                        mean_istd_path=os.path.join(fx.ROOT, 'dataset',
                                                    'mean_istd.json'))
    model.load_state_dict(convert_params(load_msgpack(os.path.join(
        fx.ROOT, 'models', 'conformer_streaming_fbank', 'best_model',
        'model.msgpack'))), strict=True)
    return model.to(device).eval()


@pytest.fixture(scope='module')
def models():
    dev = _card()
    return _flagship('cpu'), _flagship(dev), dev


@pytest.mark.gpu
def test_decoder_scores_on_card_match_cpu(models):
    cpu, card, dev = models
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.normal(size=(1, 40, 256)).astype(np.float32))
    enc_lens = torch.tensor([37])
    hyps = torch.from_numpy(rng.integers(1, 424, (1, 300, 200)))
    hyp_lens = torch.from_numpy(rng.integers(0, 201, (1, 300)))
    with torch.inference_mode(), ieee_float32():
        want = cpu.attention_rescore_scores(enc, enc_lens, hyps, hyp_lens)
        got = card.attention_rescore_scores(enc.to(dev), enc_lens.to(dev),
                                            hyps.to(dev), hyp_lens.to(dev))
    assert got.is_cuda and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
def test_rescoring_pass_on_card_matches_cpu(models):
    cpu, card, dev = models
    data = np.load(fx.OUT)
    vocab = fx.vocabulary()
    feats = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 300, 80)).astype(np.float32))
    lens = torch.tensor([300, 211])
    conf = dict(fx.beam_conf(str(data['beam_conf'])))
    results = []
    for model, device in ((cpu, 'cpu'), (card, dev)):
        res = AttentionRescoringDecoder(model, vocab, ctc_weight=0.3,
                                        device=device, **conf)
        with torch.inference_mode(), ieee_float32():
            enc, probs, olens = model.encode_for_rescore(
                feats.to(device), lens.to(device))
            results.append(res.decode_batch_rescore(enc, probs, olens))
    (want, got) = results
    assert [t for _, t in got] == [t for _, t in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want],
                               rtol=RTOL, atol=ATOL)
