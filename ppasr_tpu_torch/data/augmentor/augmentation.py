"""Augmentation pipeline: the parsed augmentation.json → ordered audio
stages, each applied with its ``prob`` (counterpart of
ppasr_tpu/data/augmentor/augmentation.py:31-62).

The feature stages ('specaug', 'specsub') run on the device in the
training frontend (``ops/frontend.make_device_frontend``), which reads
them from the same list; the pipeline keeps them only to refuse
``transform_feature``: the host SpecAugment of training without the device
frontend (``feature_augmentors.py``) is not ported yet (ROADMAP Queue A,
item 12)."""
import random

from ppasr_tpu_torch.data.augmentor.audio_augmentors import (
    NoisePerturbAugmentor, ResampleAugmentor, ShiftPerturbAugmentor,
    SpeedPerturbAugmentor, VolumePerturbAugmentor)
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)

_AUDIO_TYPES = {
    'noise': NoisePerturbAugmentor,
    'resample': ResampleAugmentor,
    'speed': SpeedPerturbAugmentor,
    'shift': ShiftPerturbAugmentor,
    'volume': VolumePerturbAugmentor,
}
_FEATURE_TYPES = ('specaug', 'specsub')


class AugmentationPipeline:
    def __init__(self, config: list):
        """``config``: [{type, aug_type, params, prob}, ...]. An audio stage
        whose constructor raises is skipped with a warning, as in the JAX
        package."""
        self._audio_stages = []
        self._feature_stages = []
        for spec in (config or []):
            aug_type = spec.get('aug_type')
            name = spec.get('type')
            prob = float(spec.get('prob', 0.0))
            if aug_type == 'audio':
                try:
                    aug = _AUDIO_TYPES[name](**dict(spec.get('params', {})))
                except (KeyError, TypeError, ValueError) as e:
                    logger.warning(f"skipping augmentor {name}: {e!r}")
                    continue
                self._audio_stages.append((aug, prob, name))
            elif aug_type == 'feature' and name in _FEATURE_TYPES:
                self._feature_stages.append((name, prob))
            else:
                logger.warning(f"unknown augmentor {aug_type}/{name}")

    def transform_audio(self, audio_segment):
        for aug, prob, _ in self._audio_stages:
            if random.random() < prob:
                aug.transform_audio(audio_segment)

    def transform_feature(self, feature):
        if self._feature_stages:
            raise NotImplementedError(
                "host feature augmentation (SpecAugment/SpecSub on the host "
                "features) is not ported yet (ROADMAP Queue A, item 12); "
                "train with train_conf.device_frontend")
        return feature
