"""The port's manifest builders (ppasr_tpu_torch/data/manifest.py) and
binary store (data/binary.py) against the JAX package's, on an annotation
directory of eight 16 kHz WAVs (the training fixture's utterances) with a
``train.txt`` of six and a ``test.txt`` of two lines, plus a line of an
absent file and a malformed one:

- ``create_manifest``, ``create_noise``, ``count_manifest`` and
  ``merge_audio``: the files written equal the JAX package's byte for
  byte (the counts equal);
- ``change_rate`` on an 8 kHz file: the resampled samples within 1e-6;
- ``create_manifest_binary`` then ``DatasetReader``: the ``.data`` and
  ``.header`` files equal JAX's, and the records read back equal, with and
  without the duration filter;
- ``is_ustr`` and ``buf_to_float`` on the same inputs.
"""
import os
import shutil
from collections import Counter

import numpy as np
import pytest

import make_torch_train_fixture as tf
from ppasr_tpu.data import binary as jax_binary
from ppasr_tpu.data import manifest as jax_manifest
from ppasr_tpu_torch.data import binary, manifest
from ppasr_tpu_torch.data.audio import AudioSegment

PACKAGES = {'jax': (jax_manifest, jax_binary), 'torch': (manifest, binary)}


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp('annotation_root')
    data = tf.load()
    ann = d / 'annotation'
    (d / 'wav').mkdir()
    ann.mkdir()
    lines = []
    for i, (pcm, text) in enumerate(zip(tf.pcms(data), data['texts'])):
        wav = d / 'wav' / f'{i}.wav'
        AudioSegment.from_ndarray(pcm).to_wav_file(str(wav))
        lines.append(f'{wav}\t{str(text).upper()}，A b!\n')
    (ann / 'train.txt').write_text(
        ''.join(lines[:6]) + f"{d / 'wav' / 'absent.wav'}\tx\n"
        + 'no tab here\n', encoding='utf-8')
    (ann / 'test.txt').write_text(''.join(lines[6:]), encoding='utf-8')
    (ann / 'notes.md').write_text('not a list\n', encoding='utf-8')
    return d


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def test_create_manifest_and_count_match_jax(corpus, tmp_path):
    out = {}
    for name, (mod, _) in PACKAGES.items():
        train, test = tmp_path / name / 'manifest.train', \
            tmp_path / name / 'manifest.test'
        mod.create_manifest(str(corpus / 'annotation'), str(train),
                            str(test))
        counter = Counter()
        mod.count_manifest(counter, str(train))
        out[name] = (_read(train), _read(test), counter)
    assert out['torch'] == out['jax']
    assert out['torch'][0].count(b'\n') == 6
    assert out['torch'][1].count(b'\n') == 2


def test_create_noise_matches_jax(corpus, tmp_path):
    noise = tmp_path / 'noise'
    noise.mkdir()
    for i in (0, 3):
        shutil.copy(corpus / 'wav' / f'{i}.wav', noise / f'n{i}.wav')
    (noise / 'readme.txt').write_text('not audio', encoding='utf-8')
    got = {}
    for name, (mod, _) in PACKAGES.items():
        path = tmp_path / name / 'manifest.noise'
        mod.create_noise(str(noise), str(path))
        got[name] = _read(path)
    assert got['torch'] == got['jax'] and got['torch'].count(b'\n') == 2


def test_merge_audio_matches_jax(corpus, tmp_path):
    ann = tmp_path / 'annotation'
    shutil.copytree(corpus / 'annotation', ann)
    got = {}
    for name, (mod, _) in PACKAGES.items():
        merged = tmp_path / f'merged_{name}'
        mod.merge_audio(str(ann), str(merged), max_duration=3.0)
        files = {p.name: _read(p) for p in sorted(merged.iterdir())}
        lists = {p.name: _read(p).replace(str(merged).encode(), b'<dir>')
                 for p in sorted(ann.glob('*.merged.jsonl'))}
        got[name] = (files, lists)
    assert got['torch'] == got['jax']
    files, lists = got['torch']
    assert len(files) == 4 and set(lists) == {'train.txt.merged.jsonl',
                                              'test.txt.merged.jsonl'}


def test_change_rate_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(8000) * 3000).astype(np.int16)
    got = {}
    for name, (mod, _) in PACKAGES.items():
        path = str(tmp_path / f'{name}.wav')
        AudioSegment(x, 8000).to_wav_file(path)
        mod.change_rate(path, 16000)
        seg = AudioSegment.from_file(path)
        assert seg.sample_rate == 16000
        got[name] = seg.samples
    assert got['torch'].shape == got['jax'].shape == (16000,)
    np.testing.assert_allclose(got['torch'], got['jax'], rtol=0, atol=1e-6)


def test_binary_store_matches_jax(corpus, tmp_path):
    stores = {}
    for name, (mod, bin_mod) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        mod.create_manifest(str(corpus / 'annotation'),
                            str(d / 'manifest.train'),
                            str(d / 'manifest.test'))
        mod.create_manifest_binary(str(d / 'manifest.train'),
                                   str(d / 'manifest.test'))
        stores[name] = {p.name: _read(p) for p in sorted(d.iterdir())
                        if p.suffix in ('.data', '.header')}
        records = []
        for kw in (dict(), dict(min_duration=1.4, max_duration=1.6),
                   dict(max_duration=-1)):
            r = bin_mod.DatasetReader(str(d / 'manifest.train'), **kw)
            records.append([r.get_data(i) for i in r.get_keys()])
            r.close()
        stores[name]['records'] = records
    assert stores['torch'] == stores['jax']
    assert len(stores['torch']['records'][0]) == 6
    assert 0 < len(stores['torch']['records'][1]) < 6


def test_text_and_pcm_helpers_match_jax():
    for text in ('Hello, 世界！ 123', 'ａｂ—c d', '', '的时 ~X'):
        assert manifest.is_ustr(text) == jax_manifest.is_ustr(text)
    buf = np.arange(-300, 300, 7, dtype='<i2').tobytes()
    np.testing.assert_array_equal(manifest.buf_to_float(buf),
                                  jax_manifest.buf_to_float(buf))
