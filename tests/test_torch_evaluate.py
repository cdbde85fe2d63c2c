"""The port's ``PPASRTrainer.evaluate`` with every decoder against the JAX
trainer's, on the CPU: a tiny streaming Conformer (2 blocks of 32, a 1 + 1
block attention decoder) built from configs/conformer.yml with the
committed vocabulary and CMVN and ``fill_weights``' parameters, saved as a
``model.msgpack`` that both trainers load, evaluated over the recipe's
eleven utterances (``make_torch_recipe_fixture``) in one batch:

- greedy; ``ctc_beam_search`` (beam 8) with the backends ``torch`` (the
  JAX one is ``jax``), ``host`` and ``native``, each with
  lm/synth_lm.arpa and without an LM; ``attention_rescoring``; each at
  full context and with ``streaming_eval``: every text identical, the
  error rate equal, beam and rescoring scores within ``BEAM_SCORE_TOL``
  and the mean loss within 1e-5 relative;
- DeepSpeech2 (``torch_tiny_artifact.ZOO``): greedy and beam evaluate
  match JAX's; rescoring and ``streaming_eval`` raise (JAX decodes greedy
  for the first);
- an unknown decoder and an unknown backend raise;
- ``train`` with the stock ``decoder: ctc_beam_search`` (its conf with
  beam 10, the absent ``.klm`` decoded LM-free) and configs/
  augmentation.json's host feature stages runs one epoch and writes a
  checkpoint.
"""
import json
import os

import numpy as np
import pytest

import make_torch_recipe_fixture as rf
import make_torch_smoke_fixture as fx
from make_torch_zoo_fixture import fill_weights
from ppasr_tpu.trainer import PPASRTrainer as JaxTrainer
from ppasr_tpu.utils.common import dict_to_object
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.data.manifest import create_manifest
from ppasr_tpu_torch.decoders.beam_search_torch import TorchBeamSearchDecoder
from ppasr_tpu_torch.trainer import PPASRTrainer
from ppasr_tpu_torch.utils.checkpoint import export_params, save_msgpack
from torch_tiny_artifact import ZOO, ZOO_GAIN
from torch_train_util import DEC, ENC, one_torch_thread  # noqa: F401

LM = os.path.join(rf.ROOT, 'lm', 'synth_lm.arpa')
AUG = os.path.join(rf.ROOT, 'configs', 'augmentation.json')
BEAM = dict(alpha=0.8, beta=1.0, beam_size=8, cutoff_prob=0.99,
            cutoff_top_n=10, num_processes=1)
LOSS_RTOL = 1e-5
# (decoder, backend, language model) of each case
CASES = {
    'greedy': ('ctc_greedy', None, None),
    'torch_lm': ('ctc_beam_search', 'torch', LM),
    'torch': ('ctc_beam_search', 'torch', None),
    'host_lm': ('ctc_beam_search', 'host', LM),
    'host': ('ctc_beam_search', 'host', None),
    'native_lm': ('ctc_beam_search', 'native', LM),
    'native': ('ctc_beam_search', 'native', None),
    'rescore': ('attention_rescoring', None, None),
}


def _config(root, use_model='conformer'):
    conf = json.loads(json.dumps(load_config(rf.STOCK_CONFIG)))
    if use_model == 'conformer':
        conf['encoder_conf'].update(ENC)
        conf['decoder_conf'].update(DEC)
    else:
        conf['use_model'] = use_model
        conf['encoder_conf'], conf['decoder_conf'], conf['model_conf'] = \
            (dict(c) for c in ZOO[use_model])
    conf['train_conf'].update(log_interval=1)
    conf['dataset_conf'].update(
        train_manifest=os.path.join(root, 'manifest.train'),
        test_manifest=os.path.join(root, 'manifest.eval'),
        dataset_vocab=rf.VOCAB, mean_istd_path=rf.CMVN, batch_size=2,
        eval_batch_size=11, num_workers=1)
    return conf


def _with_decoder(conf, case):
    decoder, backend, lm = CASES[case]
    conf = json.loads(json.dumps(conf))
    conf['decoder'] = decoder
    beam = dict(BEAM, language_model_path=lm)
    if backend is not None:
        beam['backend'] = 'jax' if backend == 'torch' else backend
    conf['ctc_beam_search_decoder_conf'] = beam
    return conf


def _checkpoint(root, conf, use_model):
    model = PPASRTrainer(conf, use_gpu=False)._build_model(
        80, len(fx.vocabulary()))
    fill_weights(model, 7, ZOO_GAIN.get(use_model, 1.0))
    path = os.path.join(root, f'ckpt_{use_model}')
    os.makedirs(path)
    save_msgpack(os.path.join(path, 'model.msgpack'), export_params(model))
    return path


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('evaluate'))
    annotation = rf.write_corpus(root)
    create_manifest(annotation, os.path.join(root, 'manifest.train'),
                    os.path.join(root, 'manifest.test'))
    rf.write_eval_manifest(root)
    return root


@pytest.fixture(scope='module')
def conformer(workspace):
    conf = _config(workspace)
    ckpt = _checkpoint(workspace, conf, 'conformer')
    jax_trainer = JaxTrainer(json.loads(json.dumps(conf)))
    return conf, ckpt, jax_trainer, rf.jax_model_state(jax_trainer, ckpt)


@pytest.fixture(scope='module')
def jax_results(conformer):
    """{(case, streaming): JAX's (error, loss, texts, scores)}."""
    conf, _, trainer, loaded = conformer
    out = {}
    for case in CASES:
        for streaming in (False, True):
            trainer.configs = dict_to_object(_with_decoder(conf, case))
            out[case, streaming] = rf.jax_evaluate(
                trainer, CASES[case][0], streaming, **loaded)
    return out


def _port_evaluate(conf, ckpt, **kw):
    trainer = PPASRTrainer(conf, use_gpu=False)
    err, loss = trainer.evaluate(resume_model=ckpt, **kw)
    return err, loss, [r['text'] for r in trainer.eval_results], \
        [r['score'] for r in trainer.eval_results]


def _assert_same(got, want, scored):
    err, loss, texts, scores = got
    w_err, w_loss, w_texts, w_scores = want
    assert texts == w_texts
    assert err == w_err
    assert loss == pytest.approx(w_loss, rel=LOSS_RTOL)
    if scored:
        np.testing.assert_allclose(scores, w_scores, rtol=0,
                                   atol=fx.BEAM_SCORE_TOL)


@pytest.mark.parametrize('streaming', [False, True],
                         ids=['full', 'streaming'])
@pytest.mark.parametrize('case', list(CASES))
def test_evaluate_matches_jax(conformer, jax_results, case, streaming):
    conf, ckpt, _, _ = conformer
    got = _port_evaluate(_with_decoder(conf, case), ckpt,
                         streaming_eval=streaming)
    want = jax_results[case, streaming]
    assert len(got[2]) == 11 and any(got[2])
    scored = CASES[case][0] != 'ctc_greedy' and not (
        streaming and case == 'rescore')
    _assert_same(got, want, scored)


@pytest.fixture(scope='module')
def deepspeech2(workspace):
    conf = _config(workspace, 'deepspeech2')
    ckpt = _checkpoint(workspace, conf, 'deepspeech2')
    trainer = JaxTrainer(json.loads(json.dumps(conf)))
    return conf, ckpt, trainer, rf.jax_model_state(trainer, ckpt)


@pytest.mark.parametrize('case', ['greedy', 'torch_lm'])
def test_deepspeech2_evaluate_matches_jax(deepspeech2, case):
    conf, ckpt, trainer, loaded = deepspeech2
    trainer.configs = dict_to_object(_with_decoder(conf, case))
    want = rf.jax_evaluate(trainer, CASES[case][0], **loaded)
    got = _port_evaluate(_with_decoder(conf, case), ckpt)
    _assert_same(got, want, case != 'greedy')


def test_deepspeech2_rescoring_and_streaming_raise(deepspeech2):
    conf, ckpt, _, _ = deepspeech2
    with pytest.raises(ValueError, match='attention decoder'):
        _port_evaluate(_with_decoder(conf, 'rescore'), ckpt)
    with pytest.raises(NotImplementedError, match='deepspeech2'):
        _port_evaluate(conf, ckpt, streaming_eval=True)


def test_unknown_decoder_or_backend_raises(conformer):
    conf, ckpt, _, _ = conformer
    with pytest.raises(ValueError, match='unknown decoder'):
        _port_evaluate(dict(conf, decoder='ctc_prefix'), ckpt)
    bad = _with_decoder(conf, 'torch')
    bad['ctc_beam_search_decoder_conf']['backend'] = 'tpu'
    with pytest.raises(ValueError, match='backend'):
        _port_evaluate(bad, ckpt)


def test_train_with_the_stock_beam_decoder(workspace):
    conf = _config(workspace)
    conf['dataset_conf']['test_manifest'] = os.path.join(workspace,
                                                         'manifest.test')
    conf['train_conf']['train_probe_size'] = 0
    conf['ctc_beam_search_decoder_conf']['beam_size'] = 10
    assert conf['decoder'] == 'ctc_beam_search'
    assert conf['ctc_beam_search_decoder_conf']['language_model_path'] \
        .endswith('.klm')
    trainer = PPASRTrainer(conf, use_gpu=False, data_augment_configs=AUG)
    save = os.path.join(workspace, 'trained')
    state = trainer.train(save_model_path=save, max_epoch=1,
                          log_dir=os.path.join(workspace, 'log'))
    assert state.step == 1
    assert np.isfinite(float(trainer.step_losses[0]))
    assert len(trainer.eval_results) == 3
    best = os.path.join(save, 'conformer_streaming_fbank', 'best_model')
    assert os.path.exists(os.path.join(best, 'model.msgpack'))
    assert isinstance(trainer._eval_decoder, TorchBeamSearchDecoder)
