"""Write tests/fixtures/torch_recipe.npz: the JAX package's outputs of
the stock recipe (create_data → train → eval → export) on the eleven
committed utterances, for the port's card check (chip_smoke.py's recipe
phase) and its CPU tests. JAX is imported inside the functions that run
it (``main``, ``jax_model_state``, ``jax_evaluate``, ``ds2_bf16_step``);
the corpus and config helpers need numpy alone.

The corpus is the training fixture's eight utterances
(tests/fixtures/torch_train_batch.npz) as ``train.txt`` and the smoke
fixture's three (tests/fixtures/torch_smoke_utts.npz) as ``test.txt``,
written as WAVs into an annotation directory (``write_corpus``). On the
CPU, in float32 with ``jax_default_matmul_precision`` highest:

- ``create_data`` with configs/conformer.yml pointed at the workspace
  (``workspace_overwrites``): ``manifest_train``/``manifest_test``, the
  manifests' lines with the workspace's root replaced by ``ROOT_MARK``,
  ``vocabulary`` (the file's text) and ``mean``/``istd``;
- ``evaluate`` of the committed flagship (configs/campaign/
  conformer_synth.yml with ``eval_overwrites``: float32, the committed
  vocabulary and CMVN) over all eleven (``manifest.eval``, the train
  manifest then the test one) for each run of ``EVAL_RUNS``:
  ``eval_<run>`` the texts in manifest order, ``eval_<run>_scores`` the
  beam or rescoring scores (0 for greedy), ``eval_<run>_error`` and
  ``eval_<run>_loss``;
- ``ds2_bf16_loss``, ``_loss_ctc`` and ``_grad_norm``: DeepSpeech2 at the
  full width of configs/deepspeech2.yml with
  ``make_torch_zoo_fixture.fill_weights``' parameters, its model dtype
  bfloat16 (parameters float32, the flax cells computing in bf16), one
  deterministic step over the training batch, features from ``fbank_jax``
  without dither.

    JAX_PLATFORMS=cpu python tests/make_torch_recipe_fixture.py
"""
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tests'))
import make_torch_smoke_fixture as fx  # noqa: E402
import make_torch_train_fixture as tf  # noqa: E402

OUT = os.path.join(ROOT, 'tests', 'fixtures', 'torch_recipe.npz')
STOCK_CONFIG = os.path.join(ROOT, 'configs', 'conformer.yml')
FLAGSHIP_CONFIG = tf.CONFIG
FLAGSHIP = os.path.dirname(tf.CHECKPOINT)
VOCAB = os.path.join(ROOT, 'dataset', 'vocabulary.txt')
CMVN = os.path.join(ROOT, 'dataset', 'mean_istd.json')
ROOT_MARK = '<workspace>'
# the evaluation runs: name → (decoder, streaming_eval); the beam search
# and the rescoring take the flagship config's ctc_beam_search_decoder_conf
# (beam 300, alpha 0.8, beta 1.0, the trigram lm/synth_lm.arpa)
EVAL_RUNS = {
    'greedy': ('ctc_greedy', False),
    'beam': ('ctc_beam_search', False),
    'rescore': ('attention_rescoring', False),
    'stream_greedy': ('ctc_greedy', True),
    'stream_beam': ('ctc_beam_search', True),
}
# Tolerances of the port against these numbers: the texts equal; beam and
# rescoring scores within fx.BEAM_SCORE_TOL; the CMVN within 1e-5
# relative (both sum the same float32 features in the same order); the
# mean loss within LOSS_RTOL (float32 through 12 + 6 blocks in either
# framework, as tf.F32_RTOL); the DS2 bf16 step within tf.BF16_LOSS_RTOL
# and tf.BF16_GRAD_NORM_RTOL.
CMVN_RTOL = 1e-5
LOSS_RTOL = 1e-3


def utterances():
    """[(int16 PCM, text, split)]: the eight training-fixture utterances
    ('train'), then the three smoke-fixture ones ('test')."""
    train = tf.load()
    smoke = np.load(fx.OUT)
    test = np.split(smoke['pcm'], np.cumsum(smoke['lengths'])[:-1])
    return ([(p, str(t), 'train') for p, t in zip(tf.pcms(train),
                                                   train['texts'])]
            + [(p, str(t), 'test') for p, t in zip(test, smoke['texts'])])


def write_corpus(root):
    """The utterances as WAVs under ``<root>/audio`` and the annotation
    lists ``<root>/annotation/{train,test}.txt`` (absolute paths); returns
    the annotation directory."""
    from ppasr_tpu_torch.data.audio import AudioSegment
    audio = os.path.join(root, 'audio')
    annotation = os.path.join(root, 'annotation')
    os.makedirs(audio, exist_ok=True)
    os.makedirs(annotation, exist_ok=True)
    lists = {'train': [], 'test': []}
    for i, (pcm, text, split) in enumerate(utterances()):
        wav = os.path.join(audio, f'{split}_{i}.wav')
        AudioSegment.from_ndarray(pcm).to_wav_file(wav)
        lists[split].append(f'{wav}\t{text}\n')
    for split, lines in lists.items():
        with open(os.path.join(annotation, f'{split}.txt'), 'w',
                  encoding='utf-8') as f:
            f.writelines(lines)
    return annotation


def workspace_overwrites(root):
    """``--overwrites`` pointing a config's dataset files at ``root``."""
    files = {'train_manifest': 'manifest.train',
             'test_manifest': 'manifest.test',
             'dataset_vocab': 'vocabulary.txt',
             'mean_istd_path': 'mean_istd.json',
             'noise_manifest_path': 'manifest.noise'}
    return ','.join(f'dataset_conf.{k}={os.path.join(root, v)}'
                    for k, v in files.items())


def write_eval_manifest(root):
    """``<root>/manifest.eval``: the train manifest's lines, then the test
    manifest's (all eleven utterances); returns its path."""
    path = os.path.join(root, 'manifest.eval')
    with open(path, 'w', encoding='utf-8') as out:
        for name in ('manifest.train', 'manifest.test'):
            with open(os.path.join(root, name), encoding='utf-8') as f:
                out.write(f.read())
    return path


def eval_overwrites(manifest):
    """The flagship config's evaluation on ``manifest``: float32, the
    committed vocabulary and CMVN."""
    return (f'dataset_conf.test_manifest={manifest},'
            f'dataset_conf.dataset_vocab={VOCAB},'
            f'dataset_conf.mean_istd_path={CMVN},'
            f'train_conf.enable_amp=False')


def masked_lines(path, root):
    """A manifest's lines with ``root`` replaced by ``ROOT_MARK``."""
    with open(path, encoding='utf-8') as f:
        return [line.replace(root, ROOT_MARK) for line in f.read()
                .splitlines()]


def read_cmvn(path):
    with open(path, encoding='utf-8') as f:
        d = json.load(f)
    return np.asarray(d['mean'], np.float64), np.asarray(d['istd'],
                                                         np.float64)


def jax_model_state(trainer, checkpoint):
    """The keywords of ``jax_evaluate`` that reuse one model: the JAX
    ``trainer``'s test dataset, model and a train state holding the
    parameters of ``<checkpoint>/model.msgpack`` (no optimizer state:
    ``evaluate`` reads the parameters alone)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization
    from ppasr_tpu.train_state import TrainState
    dataset = trainer._build_dataset(train=False)
    model = trainer._build_model(dataset.feature_dim, dataset.vocab_size)
    with open(os.path.join(checkpoint, 'model.msgpack'), 'rb') as f:
        params = jax.tree.map(jnp.asarray,
                              serialization.msgpack_restore(f.read()))
    return dict(test_dataset=dataset, model=model,
                state=TrainState(step=jnp.zeros((), jnp.int32),
                                 params=params, opt_state=None))


def jax_evaluate(trainer, decoder, streaming_eval=False, **kw):
    """The JAX trainer's ``evaluate`` with ``decoder`` (the trainer is
    reused: its compiled programs stay cached, the decoder is rebuilt) →
    (error rate, loss, [text], [score or 0.0]) in the loader's order."""
    import ppasr_tpu.trainer as jax_trainer
    trainer.configs['decoder'] = decoder
    trainer._eval_decoder = None
    texts, scores = [], []
    build = type(trainer)._build_eval_decoder

    def record(decode):
        def run(*args):
            out = decode(*args)
            scores.extend(float(s) for s, _ in out)
            return out
        return run

    def build_and_record(vocab, model=None):
        dec = build(trainer, vocab, model)
        for name in ('decode_batch', 'decode_batch_from_logits',
                     'decode_batch_rescore'):
            if hasattr(dec, name):
                setattr(dec, name, record(getattr(dec, name)))
        return dec

    cer = jax_trainer.cer

    def recording_cer(text, target):
        texts.append(text)
        return cer(text, target)

    trainer._build_eval_decoder = build_and_record
    jax_trainer.cer = recording_cer
    try:
        err, loss = trainer.evaluate(streaming_eval=streaming_eval, **kw)
    finally:
        jax_trainer.cer = cer
        del trainer._build_eval_decoder
    if not scores or streaming_eval and decoder == 'attention_rescoring':
        scores = [0.0] * len(texts)
    return err, loss, texts, scores


def ds2_bf16_step(build_model, fbank_jax, export_params):
    """The JAX DeepSpeech2's bf16 step-0 loss terms and gradient norm over
    the training batch with ``fill_weights``' parameters."""
    import jax
    import jax.numpy as jnp
    import make_torch_zoo_fixture as zf
    model, conf = zf.zoo_model('deepspeech2')
    jm = build_model('deepspeech2', 80, len(fx.vocabulary()),
                     streaming=bool(conf.get('streaming', True)),
                     encoder_conf=dict(conf.get('encoder_conf') or {}),
                     mean_istd_path=CMVN, dtype=jnp.bfloat16)
    variables = jax.tree.map(jnp.asarray, export_params(model))
    wav, wav_lens, text, text_lens = tf.batch(tf.load())
    feat, feat_lens = fbank_jax(jnp.asarray(wav, jnp.float32),
                                jnp.asarray(wav_lens))

    def loss_fn(params):
        o = jm.apply(dict(variables, params=params), feat, feat_lens,
                     jnp.asarray(text), jnp.asarray(text_lens),
                     deterministic=True)
        return o['loss'], o
    (_, o), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                              for g in jax.tree.leaves(grads))))
    return {'ds2_bf16_loss': np.float32(o['loss']),
            'ds2_bf16_loss_ctc': np.float32(o['loss_ctc']),
            'ds2_bf16_grad_norm': np.float32(norm)}


def main():
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update('jax_default_matmul_precision', 'highest')
    from ppasr_tpu.models.factory import build_model
    from ppasr_tpu.ops.fbank import fbank_jax
    from ppasr_tpu.trainer import PPASRTrainer
    from ppasr_tpu_torch.utils.checkpoint import export_params

    out = {}
    with tempfile.TemporaryDirectory() as root:
        annotation = write_corpus(root)
        PPASRTrainer(STOCK_CONFIG, overwrites=workspace_overwrites(
            root)).create_data(annotation_path=annotation, noise_dir=None)
        for split in ('train', 'test'):
            out[f'manifest_{split}'] = np.array(masked_lines(
                os.path.join(root, f'manifest.{split}'), root))
        with open(os.path.join(root, 'vocabulary.txt'),
                  encoding='utf-8') as f:
            out['vocabulary'] = np.array(f.read())
        out['mean'], out['istd'] = read_cmvn(os.path.join(root,
                                                          'mean_istd.json'))
        manifest = write_eval_manifest(root)
        trainer = PPASRTrainer(FLAGSHIP_CONFIG,
                               overwrites=eval_overwrites(manifest))
        loaded = jax_model_state(trainer, FLAGSHIP)
        for run, (decoder, streaming) in EVAL_RUNS.items():
            err, loss, texts, scores = jax_evaluate(trainer, decoder,
                                                    streaming, **loaded)
            out[f'eval_{run}'] = np.array(texts)
            out[f'eval_{run}_scores'] = np.array(scores, np.float64)
            out[f'eval_{run}_error'] = np.float64(err)
            out[f'eval_{run}_loss'] = np.float64(loss)
            print(run, err, loss, texts, flush=True)
    out.update(ds2_bf16_step(build_model, fbank_jax, export_params))
    np.savez_compressed(OUT, **out)
    print(OUT, os.path.getsize(OUT), 'bytes')
    for k, v in out.items():
        if v.ndim == 0:
            print(k, v.tolist())


if __name__ == '__main__':
    main()
