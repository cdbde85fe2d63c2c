"""The training draw of the dynamic chunk (ppasr_tpu_torch/ops/masks.py)
against ppasr_tpu/ops/masks.py ``add_optional_chunk_mask`` with
``decoding_chunk_size == 0``: the port's mask built from the raw draws that
JAX's key gives (k1 → draw ∈ [1, max_len), k2 → left draw) equals JAX's mask
exactly, with and without dynamic left chunks, over keys that reach both the
full context and small chunks. Also: the port's own draw stays in range; an
encoder in eval mode on a dynamic-chunk model uses the full context, and in
train mode the chunk its generator draws."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppasr_tpu.ops import masks as jax_masks
from ppasr_tpu_torch.models.conformer_encoder import ConformerEncoder
from ppasr_tpu_torch.ops import masks
from torch_train_util import ENC, one_torch_thread  # noqa: F401

MAX_LEN = 37
PAD = np.arange(MAX_LEN)[None, :] < np.array([MAX_LEN, 20])[:, None]


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_mask_and_draw(key, left):
    """JAX's training mask of PAD for ``key``, and the raw draws it made
    (k1 → draw, k2 → left draw, as add_optional_chunk_mask splits the
    key)."""
    mask = jax_masks.add_optional_chunk_mask(
        MAX_LEN, jnp.asarray(PAD)[:, None, :], True, left, 0, 0, -1,
        rng=key)
    k1, k2 = jax.random.split(key)
    draw = jax.random.randint(k1, (), 1, max(MAX_LEN, 2), dtype=jnp.int32)
    left_draw = jax.random.randint(k2, (), 0, 2 ** 30, dtype=jnp.int32)
    return mask, draw, left_draw


@pytest.mark.parametrize('left', [False, True])
def test_mask_from_jax_draw_equals_jax(left):
    seen_full = seen_chunk = False
    for seed in range(24):
        mask, d, l_draw = _jax_mask_and_draw(jax.random.PRNGKey(seed), left)
        want = np.asarray(mask)
        draw = int(d), int(l_draw)
        got = masks.add_optional_chunk_mask(
            MAX_LEN, torch.from_numpy(PAD)[:, None, :], True, left, 0, 0, -1,
            chunk_draw=draw).numpy()
        np.testing.assert_array_equal(got, want)
        chunk, _ = masks.dynamic_chunk_from_draw(*draw, MAX_LEN, left)
        seen_full |= chunk == MAX_LEN
        seen_chunk |= chunk < MAX_LEN
    assert seen_full and seen_chunk


def test_own_draw_in_range():
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        draw, left = masks.draw_dynamic_chunk(MAX_LEN, gen)
        assert 1 <= draw < MAX_LEN and 0 <= left < 2 ** 30
        chunk, n_left = masks.dynamic_chunk_from_draw(draw, left, MAX_LEN,
                                                      True)
        assert chunk == MAX_LEN or 1 <= chunk <= 25
        assert n_left == -1 or 0 <= n_left < max((MAX_LEN - 1) // chunk, 1)


def test_eval_mode_uses_full_context():
    enc = ConformerEncoder(80, use_dynamic_chunk=True, causal=True,
                           dropout_rate=0.0, positional_dropout_rate=0.0,
                           **dict(ENC))
    x = torch.randn(2, 64, 80)
    lens = torch.tensor([64, 50])
    enc.eval()
    full, _ = enc(x, lens, decoding_chunk_size=-1)
    got, _ = enc(x, lens)
    torch.testing.assert_close(got, full, rtol=0, atol=0)
    enc.train()
    t_sub = full.shape[1]
    seed = next(s for s in range(100) if masks.dynamic_chunk_from_draw(
        *masks.draw_dynamic_chunk(t_sub, torch.Generator().manual_seed(s)),
        t_sub, False)[0] < t_sub)            # a seed that draws a chunk
    a, _ = enc(x, lens, chunk_generator=torch.Generator().manual_seed(seed))
    assert not torch.allclose(a, full)
