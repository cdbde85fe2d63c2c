"""Feature CMVN statistics (copy of ppasr_tpu/data/normalizer.py:24-87):
``mean_istd.json`` holds {mean, istd, feature_method}; ``apply`` computes
(x − mean)·istd; ``compute_mean_istd`` featurizes ``num_samples``
utterances drawn with ``random.Random(seed).sample`` (all of them when
``num_samples`` is negative or exceeds the manifest) through the host
featurizer on a thread pool, sums each dimension and its square in
manifest order, and writes the JSON.
"""
import json
import math
import os
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.data.featurizer.audio_featurizer import AudioFeaturizer
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)


class FeatureNormalizer:
    def __init__(self, mean_istd_filepath: str, eps: float = 1e-20):
        self.mean_istd_filepath = mean_istd_filepath
        self.mean, self.istd = None, None
        if mean_istd_filepath and os.path.exists(mean_istd_filepath):
            with open(mean_istd_filepath, 'r', encoding='utf-8') as f:
                data = json.load(f)
            self.mean = np.asarray(data['mean'], np.float32)
            self.istd = np.maximum(np.asarray(data['istd'], np.float32), eps)

    def apply(self, features: np.ndarray) -> np.ndarray:
        """(x - mean) * istd."""
        return (features - self.mean) * self.istd

    def compute_mean_istd(self, preprocess_conf, manifest,
                          num_workers: int = 4, num_samples: int = 5000,
                          seed: int = 17):
        """Sample utterances, accumulate per-dim sum/sumsq, write JSON.

        ``manifest`` is a list of dicts with audio_filepath/text and optional
        start_time/end_time (reference normalizer.py:43-92). Sampling is
        seeded so a regenerated workspace reproduces the same stats from the
        same corpus (the committed dataset/mean_istd.json predates the seed;
        setup_campaign_workspace.sh syncs the committed file over the
        recomputed one to keep the committed checkpoint's GlobalCMVN
        consistent)."""
        if num_samples < 0 or num_samples > len(manifest):
            sampled = manifest
        else:
            sampled = random.Random(seed).sample(list(manifest), num_samples)
        logger.info(f"computing CMVN over {len(sampled)} utterances")
        conf = dict(preprocess_conf)
        featurizer = AudioFeaturizer(**conf, train=False)

        def _stats(instance):
            if 'start_time' in instance:
                audio = AudioSegment.slice_from_file(
                    instance['audio_filepath'],
                    start=instance['start_time'], end=instance['end_time'])
            else:
                audio = AudioSegment.from_file(instance['audio_filepath'])
            feat = featurizer.featurize(audio)
            return (np.sum(feat, axis=0), np.sum(np.square(feat), axis=0),
                    feat.shape[0])

        sums, sqsums, count = None, None, 0
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for s, sq, n in pool.map(_stats, sampled):
                sums = s if sums is None else sums + s
                sqsums = sq if sqsums is None else sqsums + sq
                count += n

        mean = sums / count
        var = np.maximum(sqsums / count - mean * mean, 1e-20)
        std = np.sqrt(var)
        istd = 1.0 / std
        data = {'mean': mean.tolist(), 'istd': istd.tolist(),
                'feature_method': conf.get('feature_method', 'fbank')}
        os.makedirs(os.path.dirname(self.mean_istd_filepath) or '.',
                    exist_ok=True)
        with open(self.mean_istd_filepath, 'w', encoding='utf-8') as f:
            json.dump(data, f)
        self.mean, self.istd = mean.astype(np.float32), istd.astype(np.float32)
        return self.mean, self.istd
