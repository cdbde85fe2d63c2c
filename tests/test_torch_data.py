"""The port's training data path (ppasr_tpu_torch/data/) against the JAX
package's (ppasr_tpu/data/) on the CPU, with host randomness from Python's
``random`` and numpy seeded alike in both:

- ``SortagradBatchSampler``: the same batches at epochs 0–3;
- the audio augmentors and ``AugmentationPipeline`` with
  configs/augmentation.json (the noise stage without its manifest draws
  nothing in either package): the same samples, exactly, and
  ``AudioSegment``'s transforms (``change_speed``, ``shift``, ``add_noise``
  with a noise file);
- ``ASRDataset`` in both modes (host features; raw waveforms, with
  augmentation) and ``collate_fn``/``collate_raw_fn``: equal arrays (the
  features within 1e-5, the host fbank of both being numpy's);
- ``DataLoader``: the same batches in order, without shuffling within a
  batch, and an error in the dataset reaches the consumer.
"""
import json
import os
import random

import numpy as np
import pytest

from make_torch_smoke_fixture import speechlike
from ppasr_tpu.data import audio as jax_audio
from ppasr_tpu.data import dataset as jax_dataset
from ppasr_tpu.data import loader as jax_loader
from ppasr_tpu.data import sampler as jax_sampler
from ppasr_tpu.data.augmentor.augmentation import \
    AugmentationPipeline as JaxPipeline
from ppasr_tpu_torch.data import audio, dataset, loader, manifest, sampler
from ppasr_tpu_torch.data.augmentor.augmentation import AugmentationPipeline
from torch_train_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, 'dataset', 'vocabulary.txt')
TEXTS = ['消耗创建', '具杨树北', '也可以命', '消耗', '创建具']
with open(os.path.join(ROOT, 'configs', 'augmentation.json'),
          encoding='utf-8') as f:
    AUG = json.load(f)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp('corpus')
    path = d / 'manifest.train'
    with open(path, 'w', encoding='utf-8') as f:
        for i, t in enumerate(TEXTS):
            w = speechlike(12000 + 2400 * i, seed=i) / 32768.0
            wav = str(d / f'{i}.wav')
            audio.AudioSegment.from_ndarray(w.astype(np.float32)) \
                .to_wav_file(wav)
            f.write(json.dumps({'audio_filepath': wav,
                                'duration': len(w) / 16000, 'text': t},
                               ensure_ascii=False) + '\n')
    return str(path)


@pytest.mark.parametrize('drop_last', [True, False])
def test_sampler_matches_jax(drop_last):
    for epoch in range(4):
        a = jax_sampler.SortagradBatchSampler(23, 4, drop_last=drop_last)
        b = sampler.SortagradBatchSampler(23, 4, drop_last=drop_last)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(b) == list(a) and len(b) == len(a)


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def test_audio_transforms_match_jax(tmp_path):
    x = (speechlike(16000, seed=3) / 32768).astype(np.float32)
    noise = (speechlike(6000, seed=9) / 32768 * 0.3).astype(np.float32)
    npath = str(tmp_path / 'noise.wav')
    audio.AudioSegment.from_ndarray(noise).to_wav_file(npath)
    outs = []
    for mod in (jax_audio, audio):
        seg = mod.AudioSegment.from_ndarray(x.copy())
        seg.change_speed(1.1)
        seg.shift(-3.5)
        seg.gain_db(4.0)
        nz = mod.AudioSegment.from_file(npath)
        nz = mod.AudioSegment(np.tile(nz.samples, 4), nz.sample_rate)
        _seeded(lambda: seg.add_noise(nz, 20.0), 1)
        seg.normalize(-20)
        outs.append(seg.samples)
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_pipeline_matches_jax(seed):
    x = (speechlike(20000, seed=seed) / 32768).astype(np.float32)
    outs = []
    for mod, pipe in ((jax_audio, JaxPipeline), (audio,
                                                 AugmentationPipeline)):
        p = pipe(AUG)
        seg = mod.AudioSegment.from_ndarray(x.copy())
        _seeded(lambda: p.transform_audio(seg), seed)
        outs.append((seg.samples, random.random()))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1] == outs[0][1]      # the same number of draws


def _datasets(corpus, **kw):
    return (jax_dataset.ASRDataset(corpus, VOCAB, **kw),
            dataset.ASRDataset(corpus, VOCAB, **kw))


@pytest.mark.parametrize('raw', [False, True])
def test_dataset_and_collate_match_jax(corpus, raw):
    kw = dict(preprocess_conf={'n_mels': 80}, return_raw=raw)
    if raw:
        kw.update(train=True, augmentation_config=AUG)
    a, b = _datasets(corpus, **kw)
    assert len(a) == len(b) == len(TEXTS) and b.feature_dim == 80
    items = []
    for ds in (a, b):
        items.append(_seeded(lambda: [ds[i] for i in range(len(ds))], 4))
    for (fa, ta), (fb, tb) in zip(*items):
        np.testing.assert_array_equal(tb, ta)
        np.testing.assert_allclose(fb, fa, rtol=0, atol=1e-5)
    ca = _seeded(lambda: jax_dataset.collate_fn(items[0], 64, 16), 5)
    cb = _seeded(lambda: dataset.collate_fn(items[1], 64, 16), 5)
    for x, y in zip(ca, cb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)
    if raw:
        assert cb[0].dtype == np.int16 and cb[0].shape[1] % (64 * 160) == 0


def test_loader_matches_jax_and_raises(corpus):
    a, b = _datasets(corpus, preprocess_conf={'n_mels': 80})
    batches = []
    for ds, lmod, smod in ((a, jax_loader, jax_sampler),
                           (b, loader, sampler)):
        ld = lmod.DataLoader(ds, smod.SortagradBatchSampler(
            len(ds), 2, drop_last=False, shuffle=False), num_workers=2,
            shuffle_in_batch=False)
        batches.append(list(ld))
    assert len(batches[0]) == len(batches[1]) == 3
    for x, y in zip(*batches):
        for u, v in zip(x, y):
            np.testing.assert_allclose(v, u, rtol=0, atol=1e-5)

    class Broken(dataset.ASRDataset):
        def __getitem__(self, idx):
            raise OSError("unreadable")
    bad = Broken(corpus, VOCAB)
    ld = loader.DataLoader(bad, sampler.SortagradBatchSampler(len(bad), 2))
    with pytest.raises(OSError, match='unreadable'):
        list(ld)


def test_manifest_workspace(tmp_path, monkeypatch):
    monkeypatch.setenv('PPASR_WORK', str(tmp_path))
    path = tmp_path / 'm'
    path.write_text('{"audio_filepath": "${WORK}/a.wav", "duration": 1.0, '
                    '"text": "x"}\n{"audio_filepath": "b.wav", "duration": '
                    '0.2, "text": "y"}\n', encoding='utf-8')
    from ppasr_tpu.data.manifest import read_manifest as jax_read
    assert manifest.read_manifest(str(path)) == jax_read(str(path)) == [
        {'audio_filepath': f'{tmp_path}/a.wav', 'duration': 1.0,
         'text': 'x'}]
