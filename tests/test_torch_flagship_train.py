"""The port's flagship at full width (256-dim, 12 encoder blocks, 3 + 3
decoder blocks, the committed checkpoint) on the CPU against the JAX
numbers stored in tests/fixtures/torch_train_batch.npz
(tests/make_torch_train_fixture.py): the deterministic step-0 loss terms,
token accuracy and global gradient norm over the fixture's eight
utterances, in float32, the features from the plain version of kernel B1's
batch launch. No JAX here: the fixture holds JAX's numbers. Tolerances are
the fixture module's (F32_RTOL; th_accuracy one token of the batch)."""
import os

import numpy as np
import torch

import make_torch_train_fixture as tf
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.ops.frontend import make_device_frontend
from ppasr_tpu_torch.utils.checkpoint import convert_params, load_msgpack
from torch_train_util import one_torch_thread  # noqa: F401

ROOT = tf.ROOT


def flagship():
    conf = load_config(tf.CONFIG)
    with open(os.path.join(ROOT, 'dataset', 'vocabulary.txt'),
              encoding='utf-8') as f:
        vocab_size = sum(1 for line in f if line.strip())
    model = build_model('conformer', 80, vocab_size, streaming=True,
                        encoder_conf=dict(conf.encoder_conf),
                        decoder_conf=dict(conf.decoder_conf),
                        model_conf=dict(conf.model_conf),
                        mean_istd_path=os.path.join(ROOT, 'dataset',
                                                    'mean_istd.json'))
    model.load_state_dict(convert_params(load_msgpack(tf.CHECKPOINT)),
                          strict=True)
    return model


def test_fixture_is_the_documented_batch():
    data = tf.load()
    assert [str(t) for t in data['texts']] == tf.sentences()
    assert len(tf.pcms(data)) == tf.N_UTTS and int(data['seed']) == tf.SEED
    wav, wav_lens, text, text_lens = tf.batch(data)
    assert wav.shape[1] % tf.SAMPLE_BUCKET == 0
    assert (text >= 0).sum() == text_lens.sum()


def test_step0_float32_matches_jax():
    data = tf.load()
    model = flagship().eval()
    wav, wav_lens, text, text_lens = (torch.from_numpy(np.asarray(a))
                                      for a in tf.batch(data))
    frontend = make_device_frontend({'n_mels': 80})
    feat, feat_lens = frontend(wav, wav_lens, deterministic=True)
    out = model(feat, feat_lens, text, text_lens)
    out['loss'].backward()
    grad_norm = torch.sqrt(sum((p.grad.double() ** 2).sum()
                               for p in model.parameters())).item()
    got = {k: out[k].item() for k in ('loss', 'loss_ctc', 'loss_att')}
    got['grad_norm'] = grad_norm
    for k, v in got.items():
        want = float(data[f'f32_{k}'])
        assert abs(v - want) <= tf.F32_RTOL * abs(want), (k, v, want)
    n_tokens = int(text_lens.sum()) + tf.N_UTTS        # + eos
    assert abs(out['th_accuracy'].item() - float(data['f32_th_accuracy'])) \
        <= 1.0 / n_tokens + 1e-6
