"""Augmentation pipeline: the parsed augmentation.json → ordered audio and
feature stages, each applied with its ``prob`` (counterpart of
ppasr_tpu/data/augmentor/augmentation.py:31-62, with the same draws from
Python's ``random``). The feature stages ('specaug', 'specsub';
``feature_augmentors.py``) run on host features in ``transform_feature``;
training with the device frontend runs them on the card instead
(``ops/frontend.make_device_frontend`` reads them from the same list). A
stage whose constructor raises is skipped with a warning, as in the JAX
package."""
import random

from ppasr_tpu_torch.data.augmentor.audio_augmentors import (
    NoisePerturbAugmentor, ResampleAugmentor, ShiftPerturbAugmentor,
    SpeedPerturbAugmentor, VolumePerturbAugmentor)
from ppasr_tpu_torch.data.augmentor.feature_augmentors import (
    SpecAugmentor, SpecSubAugmentor)
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)

_AUDIO_TYPES = {
    'noise': NoisePerturbAugmentor,
    'resample': ResampleAugmentor,
    'speed': SpeedPerturbAugmentor,
    'shift': ShiftPerturbAugmentor,
    'volume': VolumePerturbAugmentor,
}
_FEATURE_TYPES = {
    'specaug': SpecAugmentor,
    'specsub': SpecSubAugmentor,
}


class AugmentationPipeline:
    def __init__(self, config: list):
        """``config``: [{type, aug_type, params, prob}, ...]."""
        self._audio_stages = []
        self._feature_stages = []
        stages = {'audio': (_AUDIO_TYPES, self._audio_stages),
                  'feature': (_FEATURE_TYPES, self._feature_stages)}
        for spec in (config or []):
            aug_type = spec.get('aug_type')
            name = spec.get('type')
            prob = float(spec.get('prob', 0.0))
            if aug_type not in stages:
                logger.warning(f"unknown aug_type: {aug_type}")
                continue
            types, out = stages[aug_type]
            try:
                aug = types[name](**dict(spec.get('params', {})))
            except (KeyError, TypeError, ValueError) as e:
                logger.warning(f"skipping augmentor {name}: {e!r}")
                continue
            out.append((aug, prob, name))

    def transform_audio(self, audio_segment):
        for aug, prob, _ in self._audio_stages:
            if random.random() < prob:
                aug.transform_audio(audio_segment)

    def transform_feature(self, feature):
        for aug, prob, _ in self._feature_stages:
            if random.random() < prob:
                feature = aug.transform_feature(feature)
        return feature
