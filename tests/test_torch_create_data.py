"""The port's ``PPASRTrainer.create_data`` and ``extract_features``
(ppasr_tpu_torch/trainer.py, data/normalizer.py) against the JAX
package's, with configs/conformer.yml pointed at a workspace
(``make_torch_recipe_fixture.workspace_overwrites``) and
``manifest_type: 'binary'``, on the recipe's annotation directory (the
eleven committed utterances, eight in ``train.txt`` and three in
``test.txt``):

- the manifests, the vocabulary and the binary stores equal JAX's byte
  for byte; ``mean_istd.json``'s mean and istd within 1e-5 relative;
- ``extract_features``: the same ``manifest_features`` lines (the feature
  directory aside) and pooled arrays within 1e-5;
- an ``ASRDataset`` over the binary manifest yields the features and
  tokens of the txt one;
- the CLIs ``python -m ppasr_tpu_torch.create_data`` and
  ``extract_features`` write the same files as the trainer.
"""
import glob
import json
import os

import numpy as np
import pytest

import make_torch_recipe_fixture as rf
from ppasr_tpu.trainer import PPASRTrainer as JaxTrainer
from ppasr_tpu_torch import create_data as create_data_cli
from ppasr_tpu_torch import extract_features as extract_features_cli
from ppasr_tpu_torch.data.dataset import ASRDataset
from ppasr_tpu_torch.trainer import PPASRTrainer

BINARY = ',dataset_conf.manifest_type=binary'


@pytest.fixture(scope='module')
def prepared(tmp_path_factory):
    d = tmp_path_factory.mktemp('create_data')
    annotation = rf.write_corpus(str(d / 'corpus'))
    out = {}
    for name, cls, kw in (('jax', JaxTrainer, {}),
                          ('torch', PPASRTrainer, dict(use_gpu=False))):
        root = str(d / name)
        os.makedirs(root)
        trainer = cls(rf.STOCK_CONFIG, overwrites=rf.workspace_overwrites(
            root) + BINARY, **kw)
        trainer.create_data(annotation_path=annotation, noise_dir=None)
        trainer.extract_features(save_dir=os.path.join(root, 'features'))
        out[name] = root
    return d, annotation, out


def _bytes(path):
    with open(path, 'rb') as f:
        return f.read()


def test_create_data_matches_jax(prepared):
    _, _, roots = prepared
    names = ('manifest.train', 'manifest.test', 'vocabulary.txt',
             'manifest.train.data', 'manifest.train.header',
             'manifest.test.data', 'manifest.test.header')
    for name in names:
        assert _bytes(os.path.join(roots['torch'], name)) == \
            _bytes(os.path.join(roots['jax'], name)), name
    want = rf.read_cmvn(os.path.join(roots['jax'], 'mean_istd.json'))
    got = rf.read_cmvn(os.path.join(roots['torch'], 'mean_istd.json'))
    for g, w in zip(got, want):
        assert g.shape == (80,)
        np.testing.assert_allclose(g, w, rtol=rf.CMVN_RTOL, atol=0)
    with open(os.path.join(roots['torch'], 'manifest.train'),
              encoding='utf-8') as f:
        assert len(f.readlines()) == 8
    with open(os.path.join(roots['torch'], 'vocabulary.txt'),
              encoding='utf-8') as f:
        vocab = f.read().splitlines()
    assert vocab[:2] == ['<blank>\t-1', '<unk>\t-1'] and \
        vocab[-1] == '<eos>\t-1' and len(vocab) > 3


def _features(root, split):
    """([manifest_features entry without its path], [its rows])."""
    with open(os.path.join(root, f'manifest_features.{split}'),
              encoding='utf-8') as f:
        entries = [json.loads(line) for line in f]
    rows = []
    for e in entries:
        path = e.pop('audio_filepath')
        assert path.startswith(os.path.join(root, 'features', split))
        rows.append(np.load(path)[e['start_frame']:e['end_frame']])
    return entries, rows


def test_extract_features_matches_jax(prepared):
    _, _, roots = prepared
    for split in ('train', 'test'):
        want, got = _features(roots['jax'], split), \
            _features(roots['torch'], split)
        assert got[0] == want[0] and len(got[1]) == (8 if split == 'train'
                                                     else 3)
        for g, w in zip(got[1], want[1]):
            assert g.shape == w.shape and g.shape[1] == 80
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_binary_dataset_reads_the_txt_dataset(prepared):
    _, _, roots = prepared
    kw = dict(preprocess_conf={'n_mels': 80}, min_duration=0,
              max_duration=-1)
    vocab = os.path.join(roots['torch'], 'vocabulary.txt')
    txt = ASRDataset(os.path.join(roots['torch'], 'manifest.train'), vocab,
                     **kw)
    binary = ASRDataset(os.path.join(roots['torch'], 'manifest.train'),
                        vocab, manifest_type='binary', **kw)
    assert len(binary) == len(txt) == 8
    for i in range(len(txt)):
        assert binary.entry(i) == txt.entry(i)
        (fa, ta), (fb, tb) = txt[i], binary[i]
        np.testing.assert_array_equal(fb, fa)
        np.testing.assert_array_equal(tb, ta)
    with pytest.raises(ValueError, match='txt manifest'):
        ASRDataset(os.path.join(roots['torch'], 'manifest.train'), vocab,
                   manifest_type='binary', return_raw=True, **kw)


def test_clis_write_what_the_trainer_writes(prepared):
    d, annotation, roots = prepared
    root = str(d / 'cli')
    os.makedirs(root)
    overwrites = rf.workspace_overwrites(root) + BINARY
    create_data_cli.main(['--configs', rf.STOCK_CONFIG, '--annotation_path',
                          annotation, '--noise_dir', '', '--overwrites',
                          overwrites])
    for name in ('manifest.train', 'manifest.test', 'vocabulary.txt',
                 'mean_istd.json', 'manifest.test.data'):
        assert _bytes(os.path.join(root, name)) == \
            _bytes(os.path.join(roots['torch'], name)), name
    extract_features_cli.main(['--configs', rf.STOCK_CONFIG, '--save_dir',
                               os.path.join(root, 'features'), '--splits',
                               'test', '--overwrites', overwrites])
    assert not os.path.exists(os.path.join(root, 'manifest_features.train'))
    got, want = _features(root, 'test'), _features(roots['torch'], 'test')
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    assert len(glob.glob(os.path.join(root, 'features', 'test', '*',
                                      '*.npy'))) == 1

