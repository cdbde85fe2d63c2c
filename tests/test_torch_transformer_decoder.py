"""Port parity of the attention decoder on the CPU: the JAX Conformer's
``BiTransformerDecoder`` and ``attention_rescore_scores``
(ppasr_tpu/models/{transformer_decoder,rescore}.py) against the port's, at
a small size (width 64, 4 heads, 2 + 2 decoder blocks, vocab 30), with the
JAX model's random weights converted by ``convert_params`` and inputs from
a numpy seed. The sequence helpers (``add_sos_eos``, ``reverse_pad_list``,
``subsequent_mask``) are integer functions and must be equal.

Tolerance 1e-4 absolute on the float32 logits and scores: the frameworks
sum the same products in other orders, over two decoder stacks and a
vocabulary-wide log-softmax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppasr_tpu.models.conformer import ConformerModel as JaxConformer
from ppasr_tpu.ops import common as jax_common
from ppasr_tpu.ops import masks as jax_masks
from ppasr_tpu_torch.models.conformer import ConformerModel
from ppasr_tpu_torch.ops import common, masks
from ppasr_tpu_torch.utils.checkpoint import convert_params

D, V = 80, 30
ENC = dict(output_size=64, attention_heads=4, linear_units=128, num_blocks=2,
           cnn_module_kernel=15, block_final_norm=False)
DEC = dict(attention_heads=4, linear_units=96, num_blocks=2, r_num_blocks=2)
TOL = 1e-4


@pytest.fixture(scope='module')
def pair():
    jm = JaxConformer(input_size=D, vocab_size=V, streaming=True,
                      encoder_conf=ENC, decoder_conf=DEC)
    key = jax.random.PRNGKey(5)
    params = jax.tree.map(np.asarray, jm.init(
        {'params': key, 'dropout': key, 'chunk': key},
        jnp.zeros((1, 64, D)), jnp.asarray([64]), jnp.asarray([[1, 2]]),
        jnp.asarray([2]), deterministic=True))
    tm = ConformerModel(D, V, True, dict(ENC), dict(DEC))
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm.eval()


def _hyps(seed, b, k, u):
    rng = np.random.default_rng(seed)
    hyps = rng.integers(1, V - 1, (b, k, u)).astype(np.int32)
    lens = rng.integers(0, u + 1, (b, k)).astype(np.int32)
    lens[0, 0] = u
    return hyps, lens


def test_sequence_helpers_equal_jax():
    rng = np.random.default_rng(0)
    lens = np.array([0, 3, 7, 5], np.int32)
    ys = rng.integers(0, V, (4, 7)).astype(np.int32)
    ys[np.arange(7)[None, :] >= lens[:, None]] = -1
    for want, got in zip(
            jax_common.add_sos_eos(jnp.asarray(ys), jnp.asarray(lens), 29, 28),
            common.add_sos_eos(torch.from_numpy(ys), torch.from_numpy(lens),
                               29, 28)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        common.reverse_pad_list(torch.from_numpy(ys),
                                torch.from_numpy(lens)).numpy(),
        np.asarray(jax_common.reverse_pad_list(jnp.asarray(ys),
                                               jnp.asarray(lens))))
    np.testing.assert_array_equal(masks.subsequent_mask(6).numpy(),
                                  np.asarray(jax_masks.subsequent_mask(6)))


def test_decoder_logits_match_jax(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    memory = rng.normal(size=(3, 20, 64)).astype(np.float32)
    mem_lens = np.array([20, 13, 4])
    ys_in = rng.integers(0, V, (3, 9)).astype(np.int32)
    ys_lens = np.array([9, 5, 1], np.int32)
    r_ys_in = rng.integers(0, V, (3, 9)).astype(np.int32)

    def run(m, mem, mask, y, yl, ry):
        return m.decoder(mem, mask, y, yl, r_ys_in_pad=ry, deterministic=True)
    mask = np.arange(20)[None, None, :] < mem_lens[:, None, None]
    lj, rj = jm.apply(params, memory, mask, ys_in, ys_lens, r_ys_in,
                      method=run)
    with torch.no_grad():
        lt, rt = tm.decoder(torch.from_numpy(memory), torch.from_numpy(mask),
                            torch.from_numpy(ys_in).long(),
                            torch.from_numpy(ys_lens),
                            r_ys_in_pad=torch.from_numpy(r_ys_in).long())
    assert lt.shape == rt.shape == (3, 9, V)
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= TOL
    assert np.abs(rt.numpy() - np.asarray(rj)).max() <= TOL


@pytest.mark.parametrize('reverse_weight', [0.3, 0.0])
def test_attention_rescore_scores_match_jax(pair, reverse_weight):
    jm, params, tm = pair
    jm = jm.clone(reverse_weight=reverse_weight)
    tm.reverse_weight = reverse_weight
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(2, 24, 64)).astype(np.float32)
    enc_lens = np.array([24, 11], np.int32)
    hyps, hyp_lens = _hyps(3, 2, 5, 12)
    want = jm.apply(params, enc, enc_lens, hyps, hyp_lens,
                    method='attention_rescore_scores')
    with torch.no_grad():
        got = tm.attention_rescore_scores(
            torch.from_numpy(enc), torch.from_numpy(enc_lens),
            torch.from_numpy(hyps), torch.from_numpy(hyp_lens))
    assert got.dtype == torch.float32 and got.shape == (2, 5)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
