"""The operation counts against an independent count at tiny shapes
(PyTorch's ``FlopCounterMode`` over the reference, less the cache frames
its convolution module recomputes), and B1's bound against the
repository's ``chip_smoke.bound_ms`` at its four launch shapes."""
import copy
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import weights
from reference import conformer as ref_conformer
from reference import efficient_conformer as ref_eff

BENCH = Path(__file__).resolve().parents[1]


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny(config):
    conf = json.loads((BENCH / 'configs' / f'{config}.json').read_text())
    conf = copy.deepcopy(conf)
    conf['encoder_conf'].update(output_size=8, attention_heads=2,
                                linear_units=16, num_blocks=5)
    conf['vocab_size'], conf['input_dim'] = 7, 13
    return conf


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_conformer_chunk_flops():
    conf = tiny('conformer')
    flops = load(BENCH / 'flops' / 'conformer.py', 'f_conformer')
    W = weights.make_weights(ref_conformer.param_shapes(conf), 1, 'cpu')
    cmvn = torch.zeros(13), torch.ones(13)
    stream = ref_conformer.Stream(W, cmvn, conf, 8, 'cpu')
    enc = conf['encoder_conf']
    d, k = enc['output_size'], enc['cnn_module_kernel']
    recomputed = enc['num_blocks'] * 4 * (k - 1) * d * d
    with torch.no_grad():
        for _ in range(2):      # fill the cache of 8 frames
            stream.step(torch.randn(19, 13))
        for _ in range(2):      # then every cache slot holds a key
            got = counted(lambda: stream.step(torch.randn(19, 13)))
            assert flops.chunk_flops(conf, 19, 4, 8) == got - recomputed


def test_efficient_conformer_flops():
    conf = tiny('efficient_conformer')
    sys.modules.setdefault('flops', load(BENCH / 'flops' / '__init__.py',
                                         'flops'))
    flops = load(BENCH / 'flops' / 'efficient_conformer.py', 'f_eff')
    W = weights.make_weights(ref_eff.param_shapes(conf), 1, 'cpu')
    cmvn = torch.zeros(13), torch.ones(13)
    _, _, _, kernels = ref_eff._eff(conf)
    d = conf['encoder_conf']['output_size']
    recomputed = sum(4 * (k - 1) * d * d for k in kernels)
    for n_frames in (51, 99):   # 12 and 24 frames after subsampling
        feats = torch.randn(1, n_frames, 13)
        with torch.no_grad():
            got = counted(lambda: ref_eff.forward(
                W, cmvn, conf, feats, torch.tensor([n_frames])))
        assert flops.utterance_flops(conf, n_frames) == got - recomputed


def test_b1_bound_matches_chip_smoke():
    b1 = load(BENCH / 'flops' / 'b1.py', 'f_b1')
    sys.path.insert(0, str(BENCH.parent))
    smoke = pytest.importorskip('chip_smoke')
    peaks = {'fp32_flops': smoke.PEAK_FP32_FLOPS, 'bytes': smoke.PEAK_BYTES}
    shapes = [(67, 66 * 160 + 400, 0),            # a streamed window
              (15968, 15967 * 400 + 400, 0),      # the stride-400 batch
              (16 * 500 - 2, 16 * 80000, 0),      # predict_batch's launch
              (32 * 832 - 2, 32 * 133120, 32 * 830 * 400)]  # training
    for n_frames, samples, noise in shapes:
        want_ms, want_by = smoke.bound_ms(n_frames, samples,
                                          noise_floats=noise)
        got_s, got_by = b1.bound_s(n_frames, samples, peaks,
                                   noise_floats=noise)
        assert got_s * 1e3 == pytest.approx(want_ms, rel=1e-12)
        assert got_by == want_by
