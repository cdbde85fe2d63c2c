"""Port readers against the libraries the JAX package uses: the stdlib
msgpack decoder against ``flax.serialization.msgpack_restore`` on the
committed flagship checkpoint (bit-exact, leaf for leaf), ``convert_params``
against the port's Conformer and its attention decoder, and the YAML-subset reader against
``yaml.safe_load`` on every config."""
import glob
import os

import jax
import numpy as np
import pytest
import yaml
from flax import serialization

from ppasr_tpu_torch.config import load_config, parse_yaml_subset
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.utils.checkpoint import convert_params, msgpack_restore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'models', 'conformer_streaming_fbank',
                    'best_model', 'model.msgpack')
FLAGSHIP_CONFIG = os.path.join(ROOT, 'configs', 'campaign',
                               'conformer_synth.yml')


@pytest.fixture(scope='module')
def ckpt_bytes():
    with open(CKPT, 'rb') as f:
        return f.read()


@pytest.fixture(scope='module')
def port_tree(ckpt_bytes):
    return msgpack_restore(ckpt_bytes)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_msgpack_decoder_matches_flax_bit_exact(ckpt_bytes, port_tree):
    ref = serialization.msgpack_restore(ckpt_bytes)
    mine, theirs = _leaves(port_tree), _leaves(ref)
    assert len(mine) == len(theirs) == 596
    for (pa, a), (pb, b) in zip(mine, theirs):
        assert pa == pb
        assert a.dtype == b.dtype and a.shape == b.shape, pa
        assert a.tobytes() == b.tobytes(), pa
    assert sum(a.size for _, a in mine) == 40_325_627


def test_msgpack_decoder_scalar_types():
    import msgpack
    blob = serialization.msgpack_serialize(
        {'a': np.arange(6, dtype=np.int64).reshape(2, 3), 'b': np.float32(2.5),
         'c': [1, -3, 300, -70000, 2 ** 40, 1.5, None, True, 'x' * 40],
         'd': {'e': np.zeros((0,), np.float16)}, 'f': 1 + 2j})
    mine = msgpack_restore(blob)
    ref = msgpack.unpackb(blob, raw=False,
                          ext_hook=serialization._msgpack_ext_unpack)
    np.testing.assert_array_equal(mine['a'], ref['a'])
    assert mine['b'] == ref['b'] and type(mine['b']) is type(ref['b'])
    assert mine['c'] == ref['c'] and mine['f'] == ref['f']
    assert mine['d']['e'].dtype == np.float16


def test_convert_params_covers_encoder_and_ctc(port_tree):
    """Every leaf converted, the attention decoder's too, and the flagship
    model (decoder included) loads them with strict=True."""
    state = convert_params(port_tree)
    flat = {'/'.join(str(k.key) for k in p[1:]): a
            for p, a in _leaves(port_tree)}
    assert len(state) == len(flat) == 596
    assert sum(v.numel() for v in state.values()) == \
        sum(a.size for a in flat.values())
    # layouts: Dense transposed, NHWC conv → OIHW, depthwise [k,1,C] → [C,1,k]
    enc = 'encoder/layers_0/'
    np.testing.assert_array_equal(
        state['encoder.layers.0.self_attn.linear_q.weight'].numpy(),
        flat[enc + 'self_attn/linear_q/kernel'].T)
    np.testing.assert_array_equal(
        state['encoder.embed.Conv_1.weight'].numpy(),
        flat['encoder/embed/Conv_1/kernel'].transpose(3, 2, 0, 1))
    dw = state['encoder.layers.0.conv_module.depthwise_conv.weight']
    assert tuple(dw.shape) == (256, 1, 15)
    np.testing.assert_array_equal(
        dw.numpy()[:, 0, :],
        flat[enc + 'conv_module/depthwise_conv/kernel'][:, 0, :].T)
    np.testing.assert_array_equal(
        state['encoder.layers.0.norm_mha.weight'].numpy(),
        flat[enc + 'norm_mha/scale'])
    assert tuple(state['encoder.layers.0.self_attn.pos_bias_u'].shape) == (4, 64)
    assert tuple(state['encoder.embed.Dense_0.weight'].shape) == (256, 4864)
    # the decoder: Embed [V, D] as is, its Dense layers transposed
    dec = 'decoder/right_decoder/'
    np.testing.assert_array_equal(
        state['decoder.right_decoder.embed.weight'].numpy(),
        flat[dec + 'embed/embedding'])
    assert tuple(state['decoder.left_decoder.embed.weight'].shape) == \
        (425, 256)
    np.testing.assert_array_equal(
        state['decoder.right_decoder.output_layer.weight'].numpy(),
        flat[dec + 'output_layer/kernel'].T)
    np.testing.assert_array_equal(
        state['decoder.left_decoder.layer_2.src_attn.linear_v.weight'].numpy(),
        flat['decoder/left_decoder/layer_2/src_attn/linear_v/kernel'].T)

    cfg = load_config(FLAGSHIP_CONFIG)
    model = build_model(cfg.use_model, 80, 425, streaming=cfg.streaming,
                        encoder_conf=cfg.encoder_conf,
                        decoder_conf=cfg.decoder_conf,
                        model_conf=cfg.model_conf,
                        mean_istd_path=os.path.join(ROOT, 'dataset',
                                                    'mean_istd.json'))
    model.load_state_dict(state, strict=True)


@pytest.mark.parametrize('path', sorted(
    glob.glob(os.path.join(ROOT, 'configs', '**', '*.yml'), recursive=True)))
def test_yaml_subset_reader_equals_pyyaml(path):
    with open(path, encoding='utf-8') as f:
        text = f.read()
    assert parse_yaml_subset(text) == yaml.safe_load(text)


@pytest.mark.parametrize('text', [
    "a: 1e-6\nb: 1.e-6\nc: 0x1f\nd: 017\ne: +.inf\nf: ~\ng: off\nh: 1_000\n",
    "a:\n  - 1\n  - 'x # y'\n  -\n    b: 2\nc: \"q\\tz\"\n",
    "a: [ 'p, q', 2 ]  # c\nb: {x: 1, y: [1]}\nc:\n",
])
def test_yaml_subset_scalars_equal_pyyaml(text):
    assert parse_yaml_subset(text) == yaml.safe_load(text)
