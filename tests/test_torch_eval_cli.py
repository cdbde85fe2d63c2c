"""The port's recipe CLIs after training, on the CPU, with configs/
conformer.yml cut to a tiny width through ``--overwrites`` (2 blocks of
32, a 1 + 1 block attention decoder, the committed vocabulary and CMVN)
and a checkpoint of ``fill_weights``' parameters, over the recipe's
utterances (``make_torch_recipe_fixture``):

- ``python -m ppasr_tpu_torch.eval``: the error rate and loss of the JAX
  trainer's ``evaluate``, at full context and with ``--streaming_eval``;
- ``python -m ppasr_tpu_torch.tune``: a 2 × 2 alpha/beta grid (beam 8,
  lm/synth_lm.arpa) and a 3-point ``rescore_ctc_weight`` grid; every
  candidate's error rate and the best point equal those that
  tools/tune.py computes, one JAX ``evaluate`` per candidate;
- ``python -m ppasr_tpu_torch.export_model``: ``infer/`` holds
  ``model.msgpack``, ``inference.json`` and copies of the vocabulary and
  CMVN; ``PPASRPredictor(use_gpu=False, model_path=infer)`` gives the
  texts of the trainer's greedy ``evaluate`` on the same audio, and the
  JAX predictor reads ``model.msgpack`` and gives them too;
  ``--save_quant`` writes the int8 weights of the JAX quantization and
  ``--save_stablehlo`` the programs that ``InferencePredictor`` serves;
  ``--help`` of every CLI runs without JAX.
"""
import json
import os
import subprocess
import sys

import pytest

import make_torch_recipe_fixture as rf
import make_torch_smoke_fixture as fx
from make_torch_zoo_fixture import fill_weights
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu.trainer import PPASRTrainer as JaxTrainer
from ppasr_tpu.utils.common import dict_to_object
from ppasr_tpu_torch import eval as eval_cli
from ppasr_tpu_torch import export_model as export_cli
from ppasr_tpu_torch import tune as tune_cli
from ppasr_tpu_torch.data.manifest import create_manifest
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.trainer import PPASRTrainer
from ppasr_tpu_torch.utils.checkpoint import export_params, save_msgpack
from torch_train_util import DEC, ENC, one_torch_thread  # noqa: F401

LM = os.path.join(rf.ROOT, 'lm', 'synth_lm.arpa')
BEAM = dict(beam_size=8, cutoff_top_n=10, num_processes=1,
            language_model_path=LM)
GRID = ['--num_alphas', '2', '--num_betas', '2', '--alpha_from', '0.5',
        '--alpha_to', '2.5', '--beta_from', '0.5', '--beta_to', '3.0']
RESCORE_GRID = ['--tune_target', 'rescore', '--num_weights', '3']


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('eval_cli'))
    annotation = rf.write_corpus(root)
    create_manifest(annotation, os.path.join(root, 'manifest.train'),
                    os.path.join(root, 'manifest.test'))
    over = {f'encoder_conf.{k}': v for k, v in ENC.items()}
    over.update({f'decoder_conf.{k}': v for k, v in DEC.items()})
    over.update({f'ctc_beam_search_decoder_conf.{k}': v
                 for k, v in BEAM.items()})
    over.update({'dataset_conf.train_manifest':
                 os.path.join(root, 'manifest.train'),
                 'dataset_conf.test_manifest':
                 os.path.join(root, 'manifest.test'),
                 'dataset_conf.dataset_vocab': rf.VOCAB,
                 'dataset_conf.mean_istd_path': rf.CMVN,
                 'dataset_conf.num_workers': 1, 'decoder': 'ctc_greedy'})
    overwrites = ','.join(f'{k}={v}' for k, v in over.items())
    trainer = PPASRTrainer(rf.STOCK_CONFIG, use_gpu=False,
                           overwrites=overwrites)
    model = trainer._build_model(80, len(fx.vocabulary()))
    fill_weights(model, 7)
    ckpt = os.path.join(root, 'conformer_streaming_fbank', 'last_model')
    os.makedirs(ckpt)
    save_msgpack(os.path.join(ckpt, 'model.msgpack'), export_params(model))
    return root, ckpt, overwrites


@pytest.fixture(scope='module')
def jax_trainer(workspace):
    _, ckpt, overwrites = workspace
    trainer = JaxTrainer(rf.STOCK_CONFIG, overwrites=overwrites)
    return trainer, rf.jax_model_state(trainer, ckpt), \
        json.loads(json.dumps(trainer.configs))


@pytest.mark.parametrize('streaming', [False, True])
def test_eval_cli_matches_jax(workspace, jax_trainer, streaming):
    _, ckpt, overwrites = workspace
    trainer, err, loss = eval_cli.main([
        '--configs', rf.STOCK_CONFIG, '--use_gpu', 'False',
        '--resume_model', ckpt, '--streaming_eval', str(streaming),
        '--overwrites', overwrites])
    jt, loaded, base = jax_trainer
    jt.configs = dict_to_object(base)
    w_err, w_loss, w_texts, _ = rf.jax_evaluate(jt, 'ctc_greedy', streaming,
                                                **loaded)
    assert [r['text'] for r in trainer.eval_results] == w_texts
    assert len(w_texts) == 3 and err == w_err
    assert loss == pytest.approx(w_loss, rel=1e-5)


def _jax_tune(jax_trainer, decoder, candidates):
    """tools/tune.py's loop: one ``evaluate`` per candidate, the best the
    first lowest error rate."""
    trainer, loaded, base = jax_trainer
    tried = []
    for values in candidates:
        conf = json.loads(json.dumps(base))
        conf['ctc_beam_search_decoder_conf'].update(values)
        trainer.configs = dict_to_object(conf)
        tried.append((values, rf.jax_evaluate(trainer, decoder,
                                              **loaded)[0]))
    best = min(range(len(tried)), key=lambda i: (tried[i][1], i))
    return tried[best], tried


@pytest.mark.parametrize('target', ['lm', 'rescore'])
def test_tune_picks_the_jax_point(workspace, jax_trainer, target):
    _, ckpt, overwrites = workspace
    grid = GRID if target == 'lm' else RESCORE_GRID
    best, best_err, tried = tune_cli.main(
        ['--configs', rf.STOCK_CONFIG, '--use_gpu', 'False',
         '--resume_model', ckpt, '--overwrites', overwrites] + grid)
    assert len(tried) == (4 if target == 'lm' else 3)
    decoder = 'ctc_beam_search' if target == 'lm' else 'attention_rescoring'
    (w_best, w_err), w_tried = _jax_tune(jax_trainer, decoder,
                                         [v for v, _ in tried])
    assert [e for _, e in tried] == [e for _, e in w_tried]
    assert best == w_best and best_err == w_err
    if target == 'lm':
        assert [(v['alpha'], v['beta']) for v, _ in tried] == [
            (0.5, 0.5), (0.5, 3.0), (2.5, 0.5), (2.5, 3.0)]
    else:
        assert [v['rescore_ctc_weight'] for v, _ in tried] == [0.0, 0.5,
                                                               1.0]


def test_export_serves_in_both_predictors(workspace):
    root, ckpt, overwrites = workspace
    infer = export_cli.main(['--configs', rf.STOCK_CONFIG, '--use_gpu',
                             'False', '--save_model_path', root,
                             '--overwrites', overwrites])
    assert infer == os.path.join(root, 'conformer_streaming_fbank', 'infer')
    assert sorted(os.listdir(infer)) == ['inference.json', 'mean_istd.json',
                                         'model.msgpack', 'vocabulary.txt']
    with open(os.path.join(infer, 'inference.json'), encoding='utf-8') as f:
        meta = json.load(f)
    assert meta['use_model'] == 'conformer' and meta['input_dim'] == 80 \
        and meta['vocab_size'] == len(fx.vocabulary()) \
        and meta['encoder_conf']['output_size'] == ENC['output_size']
    trainer = PPASRTrainer(rf.STOCK_CONFIG, use_gpu=False,
                           overwrites=overwrites)
    trainer.evaluate(resume_model=ckpt)
    want = [r['text'] for r in trainer.eval_results]
    with open(os.path.join(root, 'manifest.test'), encoding='utf-8') as f:
        wavs = [json.loads(line)['audio_filepath'] for line in f]
    got = [r['text'] for r in PPASRPredictor(
        use_gpu=False, model_path=infer).predict_batch(wavs)]
    assert got == want and any(got)
    jax_got = [r['text'] for r in JaxPredictor(
        model_path=infer).predict_batch(wavs)]
    assert jax_got == want


@pytest.mark.parametrize('flag', ['--save_quant', '--save_stablehlo'])
def test_export_options_not_ported_raise(workspace, tmp_path, flag):
    """The two options, which raised while they were not ported, write
    their artifacts: the int8 weights, bit-equal to the JAX package's
    quantization of the exported weights, and the CPU programs, which
    ``InferencePredictor`` serves with the model code's posteriors."""
    root, ckpt, overwrites = workspace
    infer = export_cli.main(['--configs', rf.STOCK_CONFIG, '--use_gpu',
                             'False', '--save_model_path', str(tmp_path),
                             '--resume_model', ckpt, '--overwrites',
                             overwrites, flag, 'True'])
    if flag == '--save_quant':
        from ppasr_tpu.utils.quant import quantize_params
        from ppasr_tpu_torch.utils.checkpoint import load_msgpack
        got = load_msgpack(os.path.join(infer, 'model_quant.msgpack'))
        want = quantize_params(load_msgpack(os.path.join(infer,
                                                         'model.msgpack')))
        for part in ('q', 's', 'raw'):
            assert list(got[part]) == list(want[part])
            assert all(got[part][k].tobytes() == want[part][k].tobytes()
                       for k in want[part])
        return
    import numpy as np
    from ppasr_tpu_torch.infer_utils.inference_predictor import \
        InferencePredictor
    assert {'offline.pt2', 'chunk.pt2'} <= set(os.listdir(infer))
    prog = InferencePredictor(infer, use_gpu=False)
    code = InferencePredictor(infer, os.path.join(infer, 'mean_istd.json'),
                              use_gpu=False, use_stablehlo=False)
    x = np.random.default_rng(0).standard_normal((1, 64, 80)).astype(
        np.float32)
    assert prog.stablehlo and not code.stablehlo
    got, n = prog.predict(x, [64])
    want, _ = code.predict(x, [64])
    assert float(np.abs(got[0, :n[0]] - want[0, :n[0]]).max()) < 1e-6


def test_help_of_every_cli_runs():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    for name in ('create_data', 'extract_features', 'eval', 'tune',
                 'export_model'):
        out = subprocess.run([sys.executable, '-m', f'ppasr_tpu_torch.{name}',
                              '--help'], cwd=rf.ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and '--configs' in out.stdout, name
        assert 'jax' not in out.stderr.lower(), name
