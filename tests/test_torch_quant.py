"""The port's int8 weight quantization (ppasr_tpu_torch/utils/quant.py)
against the JAX package's (ppasr_tpu/utils/quant.py) on the same numpy
trees: the blob's int8 values, scales and raw leaves, and the dequantized
weights, equal bit for bit; each package reads the other's
``model_quant.msgpack``; both predictors serve such an artifact alone, with
the same texts."""
import os
import shutil

import jax
import numpy as np
import pytest
from flax import serialization

import torch_tiny_artifact as tiny
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu.utils import quant as jax_quant
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.utils import quant
from ppasr_tpu_torch.utils.checkpoint import (export_params, load_msgpack,
                                              save_msgpack)
from torch_train_util import one_torch_thread  # noqa: F401


def _tree(use_model):
    """A tiny model's flax tree from the port: a Conformer with BatchNorm
    in its convolution modules (so a ``batch_stats`` collection), or
    DeepSpeech2 (LSTM cells)."""
    import torch
    if use_model == 'conformer':
        enc = dict(tiny.ENC, cnn_module_norm='batch_norm')
        model = build_model('conformer', tiny.D, len(tiny.VOCAB), True, enc,
                            tiny.DEC, {'ctc_weight': 0.3})
    else:
        model = build_model('deepspeech2', tiny.D, len(tiny.VOCAB), True,
                            tiny.ZOO['deepspeech2'][0])
    model.init_weights(torch.Generator().manual_seed(1))
    return export_params(model)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


@pytest.mark.parametrize('use_model', ['conformer', 'deepspeech2'])
def test_quantize_and_dequantize_match_jax_bit_for_bit(use_model):
    tree = _tree(use_model)
    assert ('batch_stats' in tree) == (use_model == 'conformer')
    ours, theirs = quant.quantize_params(tree), jax_quant.quantize_params(tree)
    for part in ('q', 's', 'raw'):
        assert list(ours[part]) == list(theirs[part])   # same keys, order
    _assert_trees_equal(ours, theirs)
    assert any(k.endswith('/cell/ii/kernel') for k in ours['q']) \
        == (use_model == 'deepspeech2')
    assert not any(k.startswith('batch_stats') for k in ours['q'])
    _assert_trees_equal(quant.dequantize_params(ours),
                        jax_quant.dequantize_params(theirs, tree))


def test_each_package_reads_the_others_quant_file(tmp_path):
    tree = _tree('conformer')
    save_msgpack(str(tmp_path / 'port.msgpack'), quant.quantize_params(tree))
    with open(tmp_path / 'jax.msgpack', 'wb') as f:
        f.write(serialization.to_bytes(jax_quant.quantize_params(tree)))
    with open(tmp_path / 'port.msgpack', 'rb') as f:
        port_blob_in_jax = serialization.msgpack_restore(f.read())
    jax_blob_in_port = load_msgpack(str(tmp_path / 'jax.msgpack'))
    want = jax_quant.dequantize_params(jax_quant.quantize_params(tree), tree)
    _assert_trees_equal(jax_quant.dequantize_params(port_blob_in_jax, tree),
                        want)
    _assert_trees_equal(quant.dequantize_params(jax_blob_in_port), want)


def test_int8_blob_is_about_four_times_smaller():
    tree = _tree('conformer')
    blob = quant.quantize_params(tree)
    q_bytes = sum(v.nbytes for v in blob['q'].values()) \
        + sum(v.nbytes for v in blob['s'].values())
    f_bytes = sum(4 * v.size for v in blob['q'].values())
    assert q_bytes < f_bytes / 3.5


@pytest.fixture(scope='module')
def quant_dirs(tmp_path_factory):
    """The tiny artifact twice, each with a ``model_quant.msgpack`` and no
    ``model.msgpack``: the port's file, and the JAX package's of the same
    weights."""
    port = tmp_path_factory.mktemp('port_quant')
    tiny.write_zoo_artifact(port, 'conformer')
    tree = load_msgpack(str(port / 'model.msgpack'))
    os.remove(port / 'model.msgpack')
    jax_dir = tmp_path_factory.mktemp('jax_quant')
    for name in ('inference.json', 'vocabulary.txt', 'mean_istd.json'):
        shutil.copy(port / name, jax_dir / name)
    save_msgpack(str(port / 'model_quant.msgpack'),
                 quant.quantize_params(tree))
    with open(jax_dir / 'model_quant.msgpack', 'wb') as f:
        f.write(serialization.to_bytes(jax_quant.quantize_params(tree)))
    return port, jax_dir


def test_both_predictors_serve_the_int8_artifact(quant_dirs):
    port_dir, jax_dir = quant_dirs
    pcms = [tiny.speechlike(16000, 40 + i) for i in range(2)]
    got = {}
    for name, d in (('port', port_dir), ('jax', jax_dir)):
        pred = PPASRPredictor(model_path=str(d), use_gpu=False)
        got[name] = [pred.predict(p)['text'] for p in pcms]
    want = [JaxPredictor(model_path=str(port_dir)).predict(p)['text']
            for p in pcms]
    assert got['port'] == got['jax'] == want and any(want)
