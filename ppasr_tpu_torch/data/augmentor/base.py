"""Augmentor interface (copy of ppasr_tpu/data/augmentor/base.py):
audio-domain augmentors transform an AudioSegment in place;
feature-domain augmentors map [T, D] → [T, D]."""


class AugmentorBase:
    def transform_audio(self, audio_segment):
        raise NotImplementedError

    def transform_feature(self, feature):
        raise NotImplementedError
