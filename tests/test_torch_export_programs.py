"""The port's ``torch.export`` programs (ppasr_tpu_torch/infer_utils/
torch_export.py) served by its ``InferencePredictor`` (infer_utils/
inference_predictor.py), for the four families at tiny widths on the CPU:

- posteriors within PROGRAM_CODE_TOL of the port's model code (the same
  predictor with ``use_stablehlo=False``), offline at two batch sizes and
  lengths, T < 32 and T not a multiple of 16 included (the program
  pads: the model code is given the same padded input) and over streamed
  67-frame chunks; DeepSpeech2's programs run its RNNs unpacked, so they
  are held to its model code run unpacked; against the model code on the
  unpadded input (other lengths, so sums in another order; DeepSpeech2's
  packed RNN multiplies rows in shrinking groups) within PROGRAM_TOL;
- within PROGRAM_TOL of the JAX package's ``InferencePredictor`` on its
  model code (``get_encoder_out`` at the program's padded length, in the
  case the program pads, and ``get_encoder_out_chunk``), as tests/test_stablehlo_export.py holds the
  JAX programs (DeepSpeech2: PROGRAM_JAX_TOL, the port's LSTM against
  flax's cell); the EfficientConformer's outputs depend on the padding
  (its attention groups 3 frames), so it is held to its unpadded model
  code not at all;
- auto mode serves the programs only when they are complete (a streaming
  directory without ``chunk.pt2`` takes the model code), ``use_stablehlo=
  True`` without them raises, a program of another device raises, and
  serving imports no model code, from ``model_quant.msgpack`` too.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import make_torch_deploy_fixture as dfx
import torch_tiny_artifact as tiny
from ppasr_tpu.infer_utils.inference_predictor import \
    InferencePredictor as JaxInfer
from ppasr_tpu_torch.infer_utils.inference_predictor import InferencePredictor
from ppasr_tpu_torch.infer_utils.torch_export import (CHUNK_FILE,
                                                      OFFLINE_FILE,
                                                      export_programs,
                                                      load_exported)
from ppasr_tpu_torch.utils.checkpoint import load_msgpack, save_msgpack
from ppasr_tpu_torch.utils.quant import quantize_params
from torch_train_util import one_torch_thread  # noqa: F401

FAMILIES = ['conformer', 'squeezeformer', 'efficient_conformer',
            'deepspeech2']
# the fewest blocks that keep each family's structure (the Squeezeformer's
# reduce at block 1 and recover at block 2, the EfficientConformer's stride
# at block 1 inside its groups): exporting and loading are this file's cost
SHALLOW = {'squeezeformer': dict(num_blocks=3, recover_idx=2),
           'efficient_conformer': dict(num_blocks=2)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """{family: directory}: each tiny artifact with its CPU programs."""
    out = {}
    for family in FAMILIES:
        d = tmp_path_factory.mktemp(family)
        tiny.write_zoo_artifact(d, family, **SHALLOW.get(family, {}))
        code = InferencePredictor(str(d), str(d / 'mean_istd.json'),
                                  use_gpu=False, use_stablehlo=False)
        written = export_programs(code.model, str(d), family, tiny.D)
        assert [os.path.basename(p) for p in written] == [OFFLINE_FILE,
                                                          CHUNK_FILE]
        out[family] = d
    return out


def _valid_max(a, b, lens):
    return max(float(np.abs(a[i, :n] - b[i, :n]).max())
               for i, n in enumerate(lens))


# a length the program takes as it is, and one under 32 frames and off the
# 16-frame grid, which it pads
OFFLINE_CASES = [((2, 96), [96, 70]), ((3, 21), [21, 17, 13])]


@pytest.mark.parametrize('family', FAMILIES)
def test_programs_match_model_code_and_jax(exported, family):
    d = str(exported[family])
    cmvn = os.path.join(d, 'mean_istd.json')
    prog = InferencePredictor(d, use_gpu=False)
    code = InferencePredictor(d, cmvn, use_gpu=False, use_stablehlo=False)
    theirs = JaxInfer(d, cmvn, use_stablehlo=False)
    assert prog.stablehlo and prog.model is None and not code.stablehlo
    # frozen as the programs' weights are: F.linear of a non-contiguous
    # input picks its GEMM by the weight's requires_grad
    assert not any(p.requires_grad for p in code.model.parameters())
    ds2 = family == 'deepspeech2'
    jax_tol = dfx.PROGRAM_JAX_TOL.get(family, dfx.PROGRAM_TOL)
    rng = np.random.default_rng(3)
    for (b, t), lens in OFFLINE_CASES:
        x = rng.standard_normal((b, t, tiny.D)).astype(np.float32)
        lens = np.asarray(lens, np.int32)
        p1, l1 = prog.predict(x, lens)
        p2, l2 = code.predict(x, lens)
        np.testing.assert_array_equal(l1, l2)
        assert all(l1 > 0)
        # the EfficientConformer's groups of 3 frames mix the padding into
        # the last valid group, so its outputs depend on the length
        if family != 'efficient_conformer':
            assert _valid_max(p1, p2, l1) < dfx.PROGRAM_TOL, (b, t)
        # at the program's padded length; JAX once, where the program pads
        xp = np.pad(x, ((0, 0), (0, max(32, -(-t // 16) * 16) - t), (0, 0)))
        if xp.shape[1] != t:
            p3, l3 = theirs.predict(xp, lens)
            np.testing.assert_array_equal(l1, l3)
            assert _valid_max(p1, p3, l1) < jax_tol, (b, t)
        if ds2:
            code.model.encoder.unpacked = True
        try:
            p2, _ = code.predict(xp, lens)
        finally:
            if ds2:
                del code.model.encoder.unpacked
        assert _valid_max(p1, p2, l1) < dfx.PROGRAM_CODE_TOL, (b, t)
    chunk = (lambda p, w: p.predict_chunk_deepspeech(w)) if ds2 else \
        (lambda p, w: p.predict_chunk_conformer(w, 64))
    for i in range(2):
        w = rng.standard_normal((1, 67, tiny.D)).astype(np.float32)
        c1, c2, c3 = (chunk(p, w) for p in (prog, code, theirs))
        assert c1.shape == c3.shape and c1.shape[1] > 0
        assert float(np.abs(c1 - c2).max()) < dfx.PROGRAM_CODE_TOL, i
        assert float(np.abs(c1 - c3).max()) < jax_tol, i
    with pytest.raises(ValueError, match='exceeds'):
        prog.predict(np.zeros((1, 16016, tiny.D), np.float32), [16016])


def test_streaming_directory_needs_both_programs(exported, tmp_path):
    d = tmp_path / 'no_chunk'
    shutil.copytree(exported['conformer'], d)
    os.remove(d / CHUNK_FILE)
    pred = InferencePredictor(str(d), str(d / 'mean_istd.json'),
                              use_gpu=False)
    assert not pred.stablehlo and pred.model is not None
    with pytest.raises(FileNotFoundError):
        InferencePredictor(str(d), use_gpu=False, use_stablehlo=True)
    os.remove(d / OFFLINE_FILE)
    with pytest.raises(FileNotFoundError):
        InferencePredictor(str(d), use_gpu=False, use_stablehlo=True)


def test_a_program_serves_only_its_device(exported, tmp_path):
    d = tmp_path / 'card_only'
    shutil.copytree(exported['squeezeformer'], d)
    for name in (OFFLINE_FILE, CHUNK_FILE):
        os.rename(d / name, d / name.replace('.pt2', '.cuda.pt2'))
    with pytest.raises(RuntimeError, match='none for cpu'):
        load_exported(str(d), 'cpu')
    with pytest.raises(RuntimeError, match='none for cpu'):
        InferencePredictor(str(d), use_gpu=False)


SERVE = r'''
import json, sys
import numpy as np
import torch
from ppasr_tpu_torch.infer_utils.inference_predictor import InferencePredictor
torch.set_num_threads(1)    # as the model code it is held to
pred = InferencePredictor(sys.argv[1], use_gpu=False)
x = np.load(sys.argv[2])
probs, lens = pred.predict(x, np.array([x.shape[1]]))
chunk = pred.predict_chunk_conformer(x[:, :67])
mods = [m for m in sys.modules
        if m.startswith(('ppasr_tpu_torch.models', 'jax', 'flax'))
        or m == 'ppasr_tpu' or m.startswith('ppasr_tpu.')]
np.save(sys.argv[3], probs)
np.save(sys.argv[4], chunk)
print(json.dumps({'stablehlo': pred.stablehlo, 'modules': mods}))
'''


def test_serving_imports_no_model_code_from_the_int8_file(exported,
                                                          tmp_path):
    d = tmp_path / 'int8'
    shutil.copytree(exported['conformer'], d)
    save_msgpack(str(d / 'model_quant.msgpack'),
                 quantize_params(load_msgpack(str(d / 'model.msgpack'))))
    os.remove(d / 'model.msgpack')
    x = np.random.default_rng(5).standard_normal(
        (1, 80, tiny.D)).astype(np.float32)
    np.save(tmp_path / 'x.npy', x)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, '-c', SERVE, str(d), str(tmp_path / 'x.npy'),
         str(tmp_path / 'probs.npy'), str(tmp_path / 'chunk.npy')],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report == {'stablehlo': True, 'modules': []}
    code = InferencePredictor(str(d), str(d / 'mean_istd.json'),
                              use_gpu=False, use_stablehlo=False)
    want, lens = code.predict(x, np.array([80]))
    got = np.load(tmp_path / 'probs.npy')
    assert _valid_max(got, want, lens) < dfx.PROGRAM_CODE_TOL
    assert float(np.abs(np.load(tmp_path / 'chunk.npy')
                        - code.predict_chunk_conformer(x[:, :67])).max()) \
        < dfx.PROGRAM_CODE_TOL
