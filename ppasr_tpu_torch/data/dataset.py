"""Dataset and collate: manifest entries → padded numpy batches
(counterpart of ppasr_tpu/data/dataset.py:25-310).

``ASRDataset`` yields (features [T, D] float32, token ids [U] int32), or in
raw mode (``return_raw``, for the device frontend) (int16-scaled float32
waveform [S], token ids): the wav is read (or a [start_time, end_time]
slice of it), the audio augmentors run on it, and then the host fbank
featurizes it or, in raw mode, it is resampled and dB-normalized alone.
Precomputed pooled ``.npy`` features (``extract_features``' output) are
read through a memory map. ``manifest_type='binary'`` reads the records
of ``data/binary.DatasetReader`` (``<manifest>.data`` and ``.header``)
instead of the JSON lines. The features are not normalized here: the
model holds the CMVN, and the trainer builds the dataset without one, so
the dataset's ``mean_istd_filepath`` is not ported.

In raw mode with every enabled audio stage native (``native_raw``), the
loader takes whole batches through ``load_raw_batch``: the C++ loader of
``data/native_pipeline`` reads, augments and normalizes them on a thread
pool, and an item it rejects goes through the Python item path. Building
the library happens with the dataset, and a failed build raises.

``collate_fn`` pads features (time and label axes rounded up to buckets,
labels padded with −1) and hands waveform items to ``collate_raw_fn``,
which rounds the samples up to ``RAW_SAMPLE_BUCKET`` = 64·160, a multiple
of 160, so kernel B1's flat launch applies as it stands, and quantizes the
waveforms to int16 for the host→device copy. ``pad_to=(frames or samples,
labels)`` raises the pad targets before the rounding: the ranks of a
multi-process run pad to a target drawn from the whole world batch, and
``pad_to_max`` pads every batch to one shape.
"""
import random

import numpy as np

from ppasr_tpu_torch.data import native_pipeline
from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.data.augmentor.augmentation import AugmentationPipeline
from ppasr_tpu_torch.data.binary import DatasetReader
from ppasr_tpu_torch.data.featurizer.audio_featurizer import AudioFeaturizer
from ppasr_tpu_torch.data.featurizer.text_featurizer import TextFeaturizer
from ppasr_tpu_torch.data.manifest import read_manifest


class ASRDataset:
    """Indexable dataset of (features or waveform, token ids)."""

    def __init__(self,
                 manifest_path: str,
                 vocab_filepath: str,
                 preprocess_conf: dict = None,
                 min_duration: float = 0.5,
                 max_duration: float = 20,
                 manifest_type: str = 'txt',
                 augmentation_config: list = None,
                 train: bool = False,
                 return_raw: bool = False):
        preprocess_conf = dict(preprocess_conf or {})
        self.dataset_reader = None
        if manifest_type == 'txt':
            if max_duration < 0:
                max_duration = float('inf')
            self.manifest = read_manifest(manifest_path,
                                          max_duration=max_duration,
                                          min_duration=min_duration)
        elif manifest_type == 'binary':
            self.dataset_reader = DatasetReader(manifest_path,
                                                min_duration=min_duration,
                                                max_duration=max_duration)
            self.manifest = None
        else:
            raise ValueError(f"unsupported manifest_type: {manifest_type}")
        self.audio_featurizer = AudioFeaturizer(**preprocess_conf, train=train)
        self.text_featurizer = TextFeaturizer(vocab_filepath)
        self.augmentation = AugmentationPipeline(augmentation_config) \
            if (train and augmentation_config) else None
        self._feature_pools = {}
        self.return_raw = bool(return_raw)
        if self.return_raw and manifest_type != 'txt':
            raise ValueError("return_raw requires a txt manifest of wavs")
        self.native_raw = self.return_raw and \
            native_pipeline.native_stages_only(self.augmentation)
        if self.native_raw:
            native_pipeline.load()
        self._sample_rate = int(preprocess_conf.get('sample_rate', 16000))
        self._target_db = (float(preprocess_conf.get('target_dB', -20))
                           if preprocess_conf.get('use_dB_normalization',
                                                  True)
                           else None)

    def __len__(self):
        if self.dataset_reader is not None:
            return len(self.dataset_reader)
        return len(self.manifest)

    def entry(self, idx: int) -> dict:
        if self.dataset_reader is not None:
            return self.dataset_reader.get_data(idx)
        return self.manifest[idx]

    def _audio(self, instance):
        path = instance['audio_filepath']
        if 'start_time' in instance:
            audio = AudioSegment.slice_from_file(
                path, start=instance['start_time'], end=instance['end_time'])
        else:
            audio = AudioSegment.from_file(path)
        if self.augmentation is not None:
            self.augmentation.transform_audio(audio)
        return audio

    def __getitem__(self, idx: int):
        instance = self.entry(idx)
        path = instance['audio_filepath']
        tokens = np.asarray(self.text_featurizer.featurize(instance['text']),
                            np.int32)
        if self.return_raw:
            if path.endswith('.npy'):
                raise ValueError(
                    "raw mode cannot read precomputed feature manifests; "
                    "point train_manifest at the wav manifest")
            samples = self.audio_featurizer.waveform(self._audio(instance))
            return samples.astype(np.float32), tokens
        if path.endswith('.npy'):
            pool = self._feature_pools.get(path)
            if pool is None:
                pool = np.load(path, mmap_mode='r')
                self._feature_pools[path] = pool
            feature = np.array(pool[instance['start_frame']:
                                    instance['end_frame'], :])
        else:
            feature = self.audio_featurizer.featurize(self._audio(instance))
        if self.augmentation is not None:
            feature = self.augmentation.transform_feature(feature)
        return feature.astype(np.float32), tokens

    def load_raw_batch(self, indices, label_bucket: int = 16, pad_to=None,
                       n_threads: int = 4):
        """Indices → (wavs [B, S] int16, labels [B, U] int32 padded with −1,
        wav_lens [B] int64, label_lens [B] int64) through the C++ loader
        (:154-195): each item's augmentation drawn in Python, S the longest
        duration times the slowest drawn speed rate plus 256 samples (at
        least ``pad_to[0]``) rounded up to ``RAW_SAMPLE_BUCKET``, U rounded
        up to ``label_bucket`` (at least ``pad_to[1]``)."""
        if not self.native_raw:
            raise ValueError("load_raw_batch needs raw mode with native "
                             "audio stages only")
        entries = [self.entry(i) for i in indices]
        params = [native_pipeline.draw_augment_params(self.augmentation)
                  for _ in entries]
        stretch = 1.0
        for p in params:
            if p.speed_rate > 0:
                stretch = max(stretch, 1.0 / p.speed_rate)
        max_s = max(int(float(e.get('duration', 0.0)) * self._sample_rate
                        * stretch) + 256 for e in entries)
        if pad_to is not None:
            max_s = max(max_s, int(pad_to[0]))
        max_s = _round_up(max_s, RAW_SAMPLE_BUCKET)
        wavs, lens = native_pipeline.load_raw_batch(
            entries, params, self._sample_rate, self._target_db, max_s,
            n_threads=n_threads)
        for j, i in enumerate(indices):
            if lens[j] < 0:  # rejected by the C++ core: the item path
                w, _ = self[i]
                n = min(len(w), max_s)
                wavs[j, :n] = w[:n]
                wavs[j, n:] = 0.0
                lens[j] = n
        texts = [np.asarray(self.text_featurizer.featurize(e['text']),
                            np.int32) for e in entries]
        max_u = max(max(len(t) for t in texts), 1)
        if pad_to is not None:
            max_u = max(max_u, int(pad_to[1]))
        max_u = _round_up(max_u, max(label_bucket, 1))
        labels = np.full((len(entries), max_u), -1, np.int32)
        label_lens = np.zeros((len(entries),), np.int64)
        for j, t in enumerate(texts):
            labels[j, :len(t)] = t
            label_lens[j] = len(t)
        return (_wav_to_int16(wavs), labels, lens.astype(np.int64),
                label_lens)

    @property
    def feature_dim(self):
        return self.audio_featurizer.feature_dim

    @property
    def vocab_size(self):
        return self.text_featurizer.vocab_size

    @property
    def vocab_list(self):
        return self.text_featurizer.vocab_list


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def collate_fn(batch, time_bucket: int = 1, label_bucket: int = 1,
               shuffle: bool = True, pad_to=None):
    """List of (feature [T, D], tokens [U]) → (inputs [B, Tmax, D] float32,
    labels [B, Umax] int32 padded with −1, input_lens [B] int64, label_lens
    [B] int64), the axes at least ``pad_to`` and rounded up to the buckets;
    the order shuffled within the batch with ``random`` when ``shuffle``.
    Waveform items go to ``collate_raw_fn``."""
    if shuffle:
        batch = list(batch)
        random.shuffle(batch)
    if batch[0][0].ndim == 1:
        return collate_raw_fn(batch, label_bucket=max(label_bucket, 1),
                              pad_to=pad_to)
    bsz = len(batch)
    dim = batch[0][0].shape[1]
    max_t = max(f.shape[0] for f, _ in batch)
    max_u = max(max(len(t) for _, t in batch), 1)
    if pad_to is not None:
        max_t = max(max_t, int(pad_to[0]))
        max_u = max(max_u, int(pad_to[1]))
    max_t = _round_up(max_t, time_bucket)
    max_u = _round_up(max_u, label_bucket)
    inputs = np.zeros((bsz, max_t, dim), np.float32)
    labels = np.full((bsz, max_u), -1, np.int32)
    input_lens = np.zeros((bsz,), np.int64)
    label_lens = np.zeros((bsz,), np.int64)
    for i, (feature, tokens) in enumerate(batch):
        t, u = feature.shape[0], len(tokens)
        inputs[i, :t] = feature
        labels[i, :u] = tokens
        input_lens[i] = t
        label_lens[i] = u
    return inputs, labels, input_lens, label_lens


# raw-waveform buckets: samples rounded up to 64 frame shifts (0.64 s)
RAW_SAMPLE_BUCKET = 64 * 160


def _wav_to_int16(wavs: np.ndarray) -> np.ndarray:
    """int16-scaled float waveforms → int16 (round, clip): half the bytes of
    the host→device copy; the rounding is well under the train-time
    dither."""
    return np.clip(np.rint(wavs), -32768, 32767).astype(np.int16)


def collate_raw_fn(batch, sample_bucket: int = RAW_SAMPLE_BUCKET,
                   label_bucket: int = 16, pad_to=None):
    """List of (waveform [S], tokens [U]) → (wavs [B, Smax] int16, labels
    [B, Umax] int32 padded with −1, wav_lens [B] int64 sample counts,
    label_lens [B] int64), the axes at least ``pad_to`` (samples,
    labels)."""
    bsz = len(batch)
    max_s = max(w.shape[0] for w, _ in batch)
    max_u = max(max(len(t) for _, t in batch), 1)
    if pad_to is not None:
        max_s = max(max_s, int(pad_to[0]))
        max_u = max(max_u, int(pad_to[1]))
    max_s = _round_up(max_s, sample_bucket)
    max_u = _round_up(max_u, label_bucket)
    wavs = np.zeros((bsz, max_s), np.float32)
    labels = np.full((bsz, max_u), -1, np.int32)
    wav_lens = np.zeros((bsz,), np.int64)
    label_lens = np.zeros((bsz,), np.int64)
    for i, (w, tokens) in enumerate(batch):
        s, u = w.shape[0], len(tokens)
        wavs[i, :s] = w
        labels[i, :u] = tokens
        wav_lens[i] = s
        label_lens[i] = u
    return _wav_to_int16(wavs), labels, wav_lens, label_lens
