"""Port parity: the torch Conformer (ppasr_tpu_torch.models) against the JAX
one (ppasr_tpu.models) on the CPU, at a small size (2 blocks, width 64,
4 heads, kernel 15, vocab 30). The JAX model is randomly initialised, its
parameters converted with ``convert_params``; inputs come from a numpy seed.

Tolerance 1e-5 absolute, float32 throughout: the two frameworks sum the
same products in other orders (matmul blocking, LayerNorm variance as
E[x²]−E[x]² in flax against two-pass in torch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppasr_tpu.models.conformer import ConformerModel as JaxConformer
from ppasr_tpu.ops import masks as jax_masks
from ppasr_tpu_torch.models.conformer import ConformerModel
from ppasr_tpu_torch.models.conformer_encoder import StreamingState
from ppasr_tpu_torch.ops import masks
from ppasr_tpu_torch.utils.checkpoint import convert_params

D, V = 80, 30
ENC = dict(output_size=64, attention_heads=4, linear_units=128, num_blocks=2,
           cnn_module_kernel=15, block_final_norm=False)
DEC = dict(attention_heads=4, linear_units=64, num_blocks=1, r_num_blocks=1)
TOL = 1e-5


def _build(streaming=True, enc=ENC, seed=0):
    rng = np.random.default_rng(seed)
    mean = tuple(np.float32(v) for v in rng.normal(size=D))
    istd = tuple(np.float32(v) for v in rng.uniform(0.5, 1.5, size=D))
    jm = JaxConformer(input_size=D, vocab_size=V, streaming=streaming,
                      encoder_conf=enc, decoder_conf=DEC, cmvn_mean=mean,
                      cmvn_istd=istd)
    key = jax.random.PRNGKey(seed)
    x = jnp.zeros((1, 64, D), jnp.float32)
    params = jm.init({'params': key, 'dropout': key, 'chunk': key}, x,
                     jnp.asarray([64]), jnp.asarray([[1, 2]]),
                     jnp.asarray([2]), deterministic=True)
    params = jax.tree.map(np.asarray, params)
    tm = ConformerModel(D, V, streaming, dict(enc), dict(DEC),
                        cmvn_mean=mean, cmvn_istd=istd)
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope='module')
def streaming_pair():
    return _build(streaming=True)


VARIANTS = {
    'streaming': None,
    'full-context': (False, ENC),
    'post-ln-abs-pos': (False, dict(ENC, normalize_before=False,
                                    macaron_style=False,
                                    pos_enc_layer_type='abs_pos',
                                    block_final_norm=True)),
    'no-pos-no-conv-gelu': (True, dict(ENC, pos_enc_layer_type='no_pos',
                                       use_cnn_module=False,
                                       activation_type='gelu')),
}


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_offline_ctc_probs_match_jax(variant, streaming_pair):
    jm, params, tm = streaming_pair if VARIANTS[variant] is None \
        else _build(*VARIANTS[variant])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 120, D)).astype(np.float32)
    lens = np.array([120, 90])
    pj, lj = jm.apply(params, jnp.asarray(x), jnp.asarray(lens),
                      method='get_encoder_out')
    with torch.no_grad():
        pt, lt = tm.get_encoder_out(torch.from_numpy(x),
                                    torch.from_numpy(lens))
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    for b, n in enumerate(np.asarray(lj)):   # padded frames are don't-care
        assert np.abs(np.asarray(pj)[b, :n] - pt.numpy()[b, :n]).max() <= TOL


def test_three_streaming_chunks_match_jax_state_for_state(streaming_pair):
    jm, params, tm = streaming_pair
    rng = np.random.default_rng(2)
    cache = 32
    sj = jm.init_state(1, cache)
    st = tm.init_state(1, cache)
    for _ in range(3):
        xc = rng.normal(size=(1, 67, D)).astype(np.float32)
        pj, sj = jm.apply(params, jnp.asarray(xc), sj,
                          method='get_encoder_out_chunk')
        with torch.no_grad():
            pt, st = tm.get_encoder_out_chunk(torch.from_numpy(xc), st)
        assert np.abs(np.asarray(pj) - pt.numpy()).max() <= TOL
        for name, a, b in zip(StreamingState._fields, sj, st):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape, name
            assert a.dtype == b.dtype, name
            assert np.abs(a - b).max() <= TOL, name


def test_chunked_equals_full_context_under_chunk_mask(streaming_pair):
    _, _, tm = streaming_pair
    rng = np.random.default_rng(3)
    n_chunks, chunk = 3, 16
    t = 64 * n_chunks + 3                       # exactly 3 chunks of 16
    x = rng.normal(size=(1, t, D)).astype(np.float32)
    with torch.no_grad():
        full, mask = tm.encoder(torch.from_numpy(x), torch.tensor([t]),
                                decoding_chunk_size=chunk,
                                num_decoding_left_chunks=-1)
        state = tm.init_state(1, chunk * n_chunks)
        outs = []
        for i in range(n_chunks):
            window = torch.from_numpy(x[:, 64 * i:64 * i + 67])
            out, state = tm.encoder.forward_chunk(window, state)
            outs.append(out)
    chunked = torch.cat(outs, dim=1)
    assert chunked.shape == full.shape == (1, chunk * n_chunks, 64)
    assert (chunked - full).abs().max().item() <= TOL


@pytest.mark.parametrize('dcs,left', [(4, -1), (4, 1), (-1, -1)])
def test_chunk_masks_match_jax(dcs, left):
    lens = np.array([10, 7])
    jpad = jax_masks.make_non_pad_mask(jnp.asarray(lens), 10)[:, None, :]
    jmask = jax_masks.add_optional_chunk_mask(10, jpad, True, False, dcs, 0,
                                              left)
    tpad = masks.make_non_pad_mask(torch.from_numpy(lens), 10)[:, None, :]
    tmask = masks.add_optional_chunk_mask(10, tpad, True, False, dcs, 0, left)
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())


def test_subsampling_flatten_order_matches_jax():
    """Conv2dSubsampling4 flattens NHWC as f*c (ppasr_tpu/models/
    subsampling.py:66-69); the port permutes its NCHW output to match."""
    from ppasr_tpu.models.subsampling import Conv2dSubsampling4 as JaxSub
    from ppasr_tpu_torch.models.subsampling import Conv2dSubsampling4
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 31, D)).astype(np.float32)
    jsub = JaxSub(8)
    params = jax.tree.map(np.asarray, jsub.init(jax.random.PRNGKey(1),
                                                jnp.asarray(x)))
    assert params['params']['Dense_0']['kernel'].shape == (19 * 8, 8)
    tsub = Conv2dSubsampling4(D, 8)
    tsub.load_state_dict(convert_params(params), strict=True)
    with torch.no_grad():
        yt = tsub(torch.from_numpy(x)).numpy()
    yj = np.asarray(jsub.apply(params, jnp.asarray(x)))
    assert yj.shape == yt.shape == (2, 7, 8)
    assert np.abs(yj - yt).max() <= TOL
