"""The plain reference agrees with the port at a tiny size on the CPU: the
fbank with both of the port's frontends, the streaming Conformer's chunk
steps and the EfficientConformer over a padded batch, on the harness's
seeded weights."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import weights
from reference import conformer as ref_conformer
from reference import efficient_conformer as ref_eff
from reference import fbank as ref_fbank

BENCH = Path(__file__).resolve().parents[1]


def tiny(config):
    conf = copy.deepcopy(json.loads(
        (BENCH / 'configs' / f'{config}.json').read_text()))
    conf['encoder_conf'].update(output_size=32, attention_heads=4,
                                linear_units=64, num_blocks=5)
    conf['decoder_conf'].update(linear_units=32, num_blocks=1,
                                r_num_blocks=1)
    conf['vocab_size'] = 50
    return conf


def port_model(conf, seed):
    from ppasr_tpu_torch.models.factory import build_model
    m = build_model(conf['use_model'], conf['input_dim'], conf['vocab_size'],
                    True, conf['encoder_conf'], conf['decoder_conf'],
                    conf['model_conf']).eval()
    family = ref_conformer if conf['family'] == 'conformer' else ref_eff
    W = weights.make_weights(family.param_shapes(conf), seed, 'cpu')
    missing, unexpected = m.load_state_dict(W, strict=False)
    assert not unexpected and all(k.startswith('decoder.') for k in missing)
    return m, W


def test_fbank_matches_both_port_frontends():
    from ppasr_tpu_torch.ops.fbank import fbank_batch_torch, fbank_numpy
    rng = np.random.default_rng(0)
    pcm = np.round(rng.normal(0, 3000, 16000)).astype(np.float32)
    ref = ref_fbank.logmel(pcm)
    np.testing.assert_allclose(fbank_numpy(pcm), ref, atol=2e-3)
    got, lens = fbank_batch_torch(torch.from_numpy(pcm)[None],
                                  torch.tensor([16000]))
    assert int(lens[0]) == ref.shape[0]
    np.testing.assert_allclose(got[0].numpy(), ref, atol=2e-3)


@pytest.mark.parametrize('seed', [1, 2 ** 31 + 5])
def test_streaming_conformer_matches(seed):
    conf = tiny('conformer')
    m, W = port_model(conf, seed)
    mean, istd = weights.make_cmvn(80, seed, 'cpu')
    m.encoder.global_cmvn = None
    state = m.init_state(1, 32)
    ref = ref_conformer.Stream(W, (mean, istd), conf, 32, 'cpu')
    worst = 0.0
    with torch.no_grad():
        for _ in range(5):      # past the 32-frame cache
            win = torch.randn(67, 80) * 3 + 12
            got, state = m.get_encoder_out_chunk(((win - mean) * istd)[None],
                                                 state)
            worst = max(worst, (got[0] - ref.step(win)).abs().max().item())
    assert worst < 1e-6


def test_efficient_conformer_matches_on_a_padded_batch():
    conf = tiny('efficient_conformer')
    m, W = port_model(conf, 3)
    mean, istd = weights.make_cmvn(80, 3, 'cpu')
    m.encoder.global_cmvn = None
    feats = torch.randn(3, 211, 80) * 3 + 12
    lens = torch.tensor([211, 150, 37])
    with torch.no_grad():
        got, got_lens = m.get_encoder_out((feats - mean) * istd, lens)
        ref, ref_lens = ref_eff.forward(W, (mean, istd), conf, feats, lens)
    assert got_lens.tolist() == ref_lens.tolist()
    for b, n in enumerate(ref_lens.tolist()):
        assert (got[b, :n] - ref[b, :n]).abs().max().item() < 1e-6
