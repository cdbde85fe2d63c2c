"""The port's host feature augmentation (ppasr_tpu_torch/data/augmentor/
feature_augmentors.py and the pipeline's feature stages) against the JAX
package's, bit for bit under the same Python seed: ``SpecAugmentor`` with
the time warp on and off and with zero fill, ``SpecSubAugmentor``, and one
``transform_feature`` through each package's ``AugmentationPipeline`` built
from configs/augmentation.json. The same number of draws is taken from
``random`` in both."""
import json
import os
import random

import numpy as np
import pytest

from ppasr_tpu.data.augmentor import feature_augmentors as jax_aug
from ppasr_tpu.data.augmentor.augmentation import \
    AugmentationPipeline as JaxPipeline
from ppasr_tpu_torch.data.augmentor import feature_augmentors as aug
from ppasr_tpu_torch.data.augmentor.augmentation import AugmentationPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, 'configs', 'augmentation.json'),
          encoding='utf-8') as _f:
    AUG = json.load(_f)


def _features(seed, t=173, d=80):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


def _both(make, seed, feature):
    """(JAX output, port output), each after random.seed(seed), and the
    next draw of ``random`` after each."""
    outs = []
    for mod in (jax_aug, aug):
        random.seed(seed)
        y = make(mod).transform_feature(feature.copy())
        outs.append((y, random.random()))
    return outs


@pytest.mark.parametrize('kw', [dict(), dict(max_time_warp=0),
                                dict(replace_with_zero=True, n_time_masks=4)],
                         ids=['warp', 'no_warp', 'zero_fill'])
@pytest.mark.parametrize('seed', [0, 7])
def test_spec_augment_matches_jax(kw, seed):
    x = _features(seed)
    (want, n_want), (got, n_got) = _both(
        lambda m: m.SpecAugmentor(inplace=False, **kw), seed, x)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert n_got == n_want
    assert not np.array_equal(got, x)


@pytest.mark.parametrize('seed', [0, 3])
def test_spec_sub_matches_jax(seed):
    x = _features(seed + 10, t=90)
    (want, n_want), (got, n_got) = _both(
        lambda m: m.SpecSubAugmentor(max_t=30, num_t_sub=3), seed, x)
    np.testing.assert_array_equal(got, want)
    assert n_got == n_want


def test_pipeline_feature_stages_match_jax():
    x = _features(5)
    outs = []
    for pipe in (JaxPipeline, AugmentationPipeline):
        p = pipe(AUG)
        random.seed(11)
        outs.append((p.transform_feature(x.copy()), random.random()))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1] == outs[0][1]
    assert [n for _, _, n in AugmentationPipeline(AUG)._feature_stages] == \
        ['specaug', 'specsub']
