"""The port's training frontend (ppasr_tpu_torch/ops/frontend.py) against
ppasr_tpu/ops/frontend.py on the CPU:

- the dithered fbank: ``fbank_batch`` on a CPU tensor (its plain version)
  given the N(0, 1) draws that ``fbank_jax(..., dither=1.0,
  dither_rng=k)`` makes from k, within 1e-4 absolute plus 1e-4 relative
  (the JAX package's float32 FFT against the port's float64 one: the same
  comparison without dither differs as much);
- SpecAugment and SpecSub: ``apply_spec_augment`` under the raw integers
  that JAX's keys give equals ``spec_augment_device`` within 1e-5
  (float32; the fill is a mean summed in another order), over utterances
  that warp and one too short to warp;
- the gate: with prob 0.5 each utterance is either the dithered fbank or
  its augmentation, as the frontend's own generator drew them, and at
  prob 1 every one is augmented; the features carry no gradient.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_torch_smoke_fixture import speechlike
from ppasr_tpu.ops.fbank import fbank_jax
from ppasr_tpu.ops.frontend import spec_augment_device
from ppasr_tpu_torch.ops import frontend
from ppasr_tpu_torch.ops.fbank_cuda import fbank_batch
from torch_train_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, 'configs', 'augmentation.json'),
          encoding='utf-8') as f:
    AUG = json.load(f)
SPEC = dict(max_time_warp=5, max_t_ratio=0.05, n_freq_masks=2,
            max_f_ratio=0.15, n_time_masks=2, replace_with_zero=False,
            spec_sub_max_t=30, spec_sub_num=3)


def _wavs():
    lens = np.array([32000, 20480, 3200])     # the last: 18 frames
    wav = np.zeros((3, 32000), np.float32)
    for b, n in enumerate(lens):
        wav[b, :n] = speechlike(int(n), seed=b)
    return wav, lens


def test_dithered_fbank_matches_jax():
    wav, lens = _wavs()
    key = jax.random.PRNGKey(7)
    want, want_lens = fbank_jax(jnp.asarray(wav), jnp.asarray(lens),
                                dither=1.0, dither_rng=key)
    noise = np.asarray(jax.random.normal(
        key, (wav.shape[0], want.shape[1], 400), jnp.float32))
    got, got_lens = fbank_batch(torch.from_numpy(wav), torch.from_numpy(lens),
                                noise=torch.from_numpy(noise.copy()))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    plain, _ = fbank_batch(torch.from_numpy(wav), torch.from_numpy(lens))
    assert (got - plain).abs().mean() > 0.01      # the dither is there


def _jax_draws(rng, bsz, nf=2, nt=2, ns=3, w=5):
    """The raw integers spec_augment_device draws from ``rng`` (:96-146),
    in one compiled function."""
    raw = lambda k: jax.random.randint(k, (), 0, 1 << 30)  # noqa: E731

    @jax.jit
    def one(key):
        keys = jax.random.split(key, 2 + nf + nt + ns)
        r_center, r_shift = jax.random.split(keys[0])
        spans = jnp.stack([jnp.stack([raw(k) for k in jax.random.split(
            keys[2 + i])]) for i in range(nf + nt)])
        sub = jnp.stack([jnp.stack([raw(k) for k in jax.random.split(
            keys[2 + nf + nt + i], 3)]) for i in range(ns)])
        return (raw(r_center), jax.random.randint(r_shift, (), -w, w + 1),
                spans[:nf], spans[nf:], sub)
    rows = [one(jax.random.fold_in(rng, b)) for b in range(bsz)]
    names = ('warp_center', 'warp_shift', 'freq', 'time', 'sub')
    return {k: torch.from_numpy(np.stack([np.asarray(r[i]) for r in rows])
                                .astype(np.int64))
            for i, k in enumerate(names)}


@pytest.mark.parametrize('replace_with_zero', [False, True])
def test_spec_augment_matches_jax_under_its_draws(replace_with_zero):
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((3, 60, 80)).astype(np.float32) + 2
    lens = np.array([60, 41, 9])       # the last too short to warp
    key = jax.random.PRNGKey(11)
    conf = dict(SPEC, replace_with_zero=replace_with_zero)
    want = np.asarray(spec_augment_device(jnp.asarray(feat),
                                          jnp.asarray(lens), key, **conf))
    got = frontend.apply_spec_augment(torch.from_numpy(feat),
                                      torch.from_numpy(lens),
                                      _jax_draws(key, 3), **conf)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want - feat).max() > 0.1       # something was applied


@pytest.mark.parametrize('prob', [0.5, 1.0])
def test_gate_and_no_gradient(prob):
    wav, lens = _wavs()
    aug = [dict(a, prob=prob) if a['aug_type'] == 'feature' else a
           for a in AUG]
    fe = frontend.make_device_frontend({'n_mels': 80}, aug)
    x = torch.from_numpy(wav).requires_grad_()
    feat, feat_lens = fe(x, torch.from_numpy(lens),
                         torch.Generator().manual_seed(5))
    assert not feat.requires_grad
    # replay the frontend's generator: the noise, then the draws
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn((3, feat.shape[1], 400), generator=gen)
    plain, _ = fbank_batch(torch.from_numpy(wav), torch.from_numpy(lens),
                           noise=noise)
    draws = frontend.draw_spec_augment(3, gen, prob=prob, spec_sub_num=3)
    augmented = frontend.apply_spec_augment(plain, feat_lens, draws, **SPEC)
    for b in range(3):
        want = augmented[b] if draws['take'][b] else plain[b]
        torch.testing.assert_close(feat[b], want, rtol=0, atol=0)
    if prob == 1.0:
        assert bool(draws['take'].all())
    eval_feat, _ = fe(x, torch.from_numpy(lens), deterministic=True)
    torch.testing.assert_close(eval_feat, fbank_batch(
        torch.from_numpy(wav), torch.from_numpy(lens))[0], rtol=0, atol=0)
