"""The port's ``VADModel`` (ppasr_tpu_torch/infer_utils/vad_predictor.py)
against the JAX package's (ppasr_tpu/infer_utils/vad_predictor.py:21-72)
with the seeded weights of make_torch_deploy_fixture.vad_params, written by
either package: probabilities within VAD_TOL over two stateful calls, and
the segmentation of ``VADPredictor`` when the model is its scorer (no Silero
weights present). The Silero weights keep their priority."""
import numpy as np
import pytest
from flax import serialization

import make_torch_deploy_fixture as dfx
import ppasr_tpu.infer_utils.vad_predictor as jax_vad
import ppasr_tpu_torch.infer_utils.vad_predictor as port_vad
from ppasr_tpu_torch.infer_utils.silero import SileroVAD
from ppasr_tpu_torch.utils.checkpoint import save_msgpack
from torch_train_util import one_torch_thread  # noqa: F401


def flax_save(path, tree):
    with open(path, 'wb') as f:
        f.write(serialization.to_bytes(tree))


@pytest.fixture(scope='module')
def vad_dirs(tmp_path_factory):
    """{'port': dir, 'jax': dir}: the seeded weights written by each."""
    return {name: str(dfx.write_vad_model(tmp_path_factory.mktemp(name),
                                          writer))
            for name, writer in (('port', save_msgpack), ('jax', flax_save))}


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_vad_model_matches_jax(vad_dirs, writer):
    theirs = jax_vad.VADModel(vad_dirs[writer])
    ours = port_vad.VADModel(vad_dirs[writer], device='cpu')
    want, got = [], []
    for windows in dfx.vad_windows():
        want.append(theirs(windows))
        got.append(ours(windows))
    want, got = np.concatenate(want), np.concatenate(got)
    assert got.dtype == np.float32 and got.shape == (sum(dfx.VAD_WINDOWS),)
    assert np.abs(got - want).max() < dfx.VAD_TOL
    assert want.max() - want.min() > 0.05      # the windows tell apart
    ours.reset()
    again = ours(np.concatenate(dfx.vad_windows()))
    assert np.abs(again - want).max() < dfx.VAD_TOL


def test_vad_predictor_segments_with_the_model(vad_dirs, monkeypatch):
    monkeypatch.setattr(port_vad, 'packaged_silero_path', lambda: '/absent')
    monkeypatch.setattr(jax_vad, '_packaged_silero_path', lambda: '/absent')
    ours = port_vad.VADPredictor(model_dir=vad_dirs['port'], device='cpu')
    theirs = jax_vad.VADPredictor(model_dir=vad_dirs['port'])
    assert isinstance(ours.model, port_vad.VADModel)
    assert isinstance(theirs.model, jax_vad.VADModel)
    wav = np.concatenate(dfx.vad_windows()).ravel()
    wav = np.concatenate([wav, wav[::-1]])
    assert ours.get_speech_timestamps(wav, threshold=0.45) == \
        theirs.get_speech_timestamps(wav, threshold=0.45)
    assert ours.stream_vad(wav) == theirs.stream_vad(wav)


def test_silero_weights_keep_priority(vad_dirs):
    pred = port_vad.VADPredictor(model_dir=vad_dirs['port'], device='cpu')
    assert isinstance(pred.model, SileroVAD)
