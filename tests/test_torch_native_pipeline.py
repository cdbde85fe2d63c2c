"""The port's native raw-audio loader (ppasr_tpu_torch/data/
native_pipeline.py, csrc/audio_pipeline.cpp built by the port's g++ rule
into build/torch_kernels/) and the dataset's batch path against the JAX
package's (ppasr_tpu/data/native_pipeline.py over its committed
libaudio_pipeline.so, ppasr_tpu/data/dataset.py:154-195), on the training
fixture's utterances written as WAVs:

- ``load_raw_batch`` on the same entries and ``ItemParams`` (plain, speed,
  shift with volume, noise): the int16-rounded batches equal, lengths
  equal (both builds compile one source with the same flags);
- each transform against the port's Python item path under the same
  decisions, within tests/test_native_pipeline.py's int16 tolerances;
- ``draw_augment_params`` draws JAX's decisions under one ``random.seed``;
- an item the C++ core rejects (an 8 kHz WAV, which needs resampling; a
  file that is no WAV) comes back with length −1, and the dataset loads
  the 8 kHz one through its Python item path;
- ``ASRDataset.load_raw_batch`` with the audio augmentation on equals the
  JAX dataset's under one seed (samples, labels, lengths);
- 1 and 4 threads give the same batch.
"""
import json
import random

import numpy as np
import pytest

from ppasr_tpu.data import native_pipeline as jax_native
from ppasr_tpu.data.augmentor.augmentation import \
    AugmentationPipeline as JaxPipeline
from ppasr_tpu.data.dataset import ASRDataset as JaxDataset
from ppasr_tpu_torch.data import native_pipeline as native
from ppasr_tpu_torch.data.augmentor.augmentation import AugmentationPipeline
from ppasr_tpu_torch.data.dataset import ASRDataset
from torch_ddp_worker import VOCAB, write_corpus
from torch_native_util import (SR, TARGET_DB, TOLERANCES, cases,
                               native_against_items, python_item, write_wav,
                               write_noise)

PREPROCESS = {'feature_method': 'fbank', 'n_mels': 80, 'sample_rate': SR,
              'use_dB_normalization': True, 'target_dB': TARGET_DB}


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('native')
    write_corpus(str(root))
    with open(root / 'manifest.train', encoding='utf-8') as f:
        entries = [json.loads(line) for line in f]
    noise = write_noise(root / 'noise.wav')
    with open(root / 'manifest.noise', 'w', encoding='utf-8') as f:
        f.write(json.dumps({'audio_filepath': noise, 'duration': 0.4}) + '\n')
    aug = [
        {'type': 'noise', 'aug_type': 'audio', 'prob': 0.5,
         'params': {'min_snr_dB': 10, 'max_snr_dB': 50, 'repetition': 2,
                    'noise_manifest_path': str(root / 'manifest.noise')}},
        {'type': 'resample', 'aug_type': 'audio', 'prob': 0.0,
         'params': {'new_sample_rate': [8000, 32000]}},
        {'type': 'speed', 'aug_type': 'audio', 'prob': 0.7,
         'params': {'min_speed_rate': 0.9, 'max_speed_rate': 1.1,
                    'num_rates': 3}},
        {'type': 'shift', 'aug_type': 'audio', 'prob': 0.6,
         'params': {'min_shift_ms': -5, 'max_shift_ms': 5}},
        {'type': 'volume', 'aug_type': 'audio', 'prob': 0.8,
         'params': {'min_gain_dBFS': -15, 'max_gain_dBFS': 15}}]
    return root, entries, noise, aug


def _rounded(wavs, lens):
    return [np.rint(wavs[j, :n]) for j, n in enumerate(lens)]


@pytest.mark.parametrize('name', ['plain', 'speed', 'shift_volume',
                                  'noise'])
def test_load_raw_batch_matches_jax(corpus, name):
    _, entries, noise, _ = corpus
    entries = entries[:6]
    for p in cases(noise)[name]:
        params = [p] * len(entries)
        got, got_lens = native.load_raw_batch(entries, params, SR, TARGET_DB,
                                              3 * SR, n_threads=2)
        want, want_lens = jax_native.load_raw_batch(
            entries, params, SR, TARGET_DB, 3 * SR, n_threads=2)
        np.testing.assert_array_equal(got_lens, want_lens)
        assert (got_lens > 0).all()
        for g, w in zip(_rounded(got, got_lens), _rounded(want, want_lens)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('name', ['plain', 'speed', 'shift_volume',
                                  'noise'])
def test_native_matches_python_item_path(corpus, name):
    _, entries, noise, _ = corpus
    errors = native_against_items(entries[:4], noise)
    assert errors[name] <= TOLERANCES[name], errors


def test_draw_augment_params_matches_jax(corpus):
    *_, aug = corpus
    port, jax_pipe = AugmentationPipeline(aug), JaxPipeline(aug)
    assert native.native_stages_only(port)
    random.seed(11)
    got = [native.draw_augment_params(port) for _ in range(64)]
    random.seed(11)
    want = [jax_native.draw_augment_params(jax_pipe) for _ in range(64)]
    for g, w in zip(got, want):
        for slot in native.ItemParams.__slots__:
            assert getattr(g, slot) == getattr(w, slot), slot
    assert any(g.noise_paths for g in got)
    resample = [dict(s, prob=0.5) if s['type'] == 'resample' else s
                for s in aug]
    assert not native.native_stages_only(AugmentationPipeline(resample))


def test_rejected_items_go_through_the_item_path(corpus, tmp_path):
    root, entries, _, _ = corpus
    pcm = np.asarray(python_item(entries[0], native.ItemParams(),
                                 target_db=None)) / 32768.0
    slow = write_wav(tmp_path / 'u8k.wav', pcm[::2].astype(np.float32),
                     sr=8000)
    bad = tmp_path / 'bad.wav'
    bad.write_bytes(b'NOTAWAV' * 10)
    rejected = [dict(entries[0], audio_filepath=slow),
                dict(entries[0], audio_filepath=str(bad))]
    _, lens = native.load_raw_batch(entries[:1] + rejected,
                                    [native.ItemParams()] * 3, SR, TARGET_DB,
                                    2 * SR)
    assert lens[0] > 0 and lens[1] == -1 and lens[2] == -1
    manifest = tmp_path / 'manifest'
    with open(manifest, 'w', encoding='utf-8') as f:
        for e in (entries[0], rejected[0], entries[2]):
            f.write(json.dumps(e, ensure_ascii=False) + '\n')
    ds = ASRDataset(str(manifest), VOCAB, preprocess_conf=PREPROCESS,
                    min_duration=0, max_duration=-1, return_raw=True)
    assert ds.native_raw
    wavs, labels, wav_lens, label_lens = ds.load_raw_batch([0, 1, 2])
    assert wavs.dtype == np.int16 and wavs.shape[1] % (64 * 160) == 0
    for j in range(3):
        w, t = ds[j]
        assert int(wav_lens[j]) == len(w)
        want = np.clip(np.rint(w), -32768, 32767)
        if j == 1:   # the item path's own samples
            np.testing.assert_array_equal(wavs[j, :len(w)], want)
        else:
            assert np.max(np.abs(wavs[j, :len(w)] - want)) <= \
                TOLERANCES['plain']
        assert list(labels[j, :int(label_lens[j])]) == list(t)


def test_dataset_load_raw_batch_matches_jax(corpus):
    root, *_, aug = corpus
    manifest = str(root / 'manifest.train')
    port = ASRDataset(manifest, VOCAB, preprocess_conf=PREPROCESS,
                      min_duration=0, augmentation_config=aug, train=True,
                      return_raw=True)
    jax_ds = JaxDataset(manifest, VOCAB, preprocess_conf=PREPROCESS,
                        min_duration=0, augmentation_config=aug, train=True,
                        return_raw=True)
    assert port.native_raw and jax_ds._native_raw
    for pad_to in (None, (3 * SR, 12)):
        random.seed(5)
        got = port.load_raw_batch(list(range(8)), label_bucket=16,
                                  pad_to=pad_to, n_threads=2)
        random.seed(5)
        want = jax_ds.load_raw_batch(list(range(8)), label_bucket=16,
                                     pad_to=pad_to, n_threads=2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_threads_give_the_same_batch(corpus):
    _, entries, noise, _ = corpus
    params = [cases(noise)['shift_volume'][0]] * 8 + \
        [cases(noise)['speed'][1]] * 8
    one = native.load_raw_batch(entries, params, SR, TARGET_DB, 2 * SR,
                                n_threads=1)
    four = native.load_raw_batch(entries, params, SR, TARGET_DB, 2 * SR,
                                 n_threads=4)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)
