"""Write tests/fixtures/torch_zoo.npz: the JAX package's outputs for the
three model families beside the Conformer — DeepSpeech2, Squeezeformer and
EfficientConformer — at the full width of their committed configs
(configs/deepspeech2.yml, squeezeformer.yml, efficient_conformer.yml) with
seeded weights, for the port's card check (chip_smoke.py's zoo phase) and
its CPU tests. Only ``main`` imports JAX; the weight helpers need numpy and
torch alone.

No checkpoint exists for these families, so the weights are drawn:
``fill_weights`` builds each family in the port and fills every parameter
from ``np.random.default_rng(SEED)`` in sorted-name order (unit-scale
matrices over sqrt(fan in), norms near 1, small biases, the CTC projection
×``LOGIT_SCALE`` so that the greedy argmax is seldom blank), and
``zoo_artifact`` writes them through ``export_params`` as the flax tree both
packages read. Only the seed and the JAX outputs are committed.

The audio is the smoke fixture's three utterances
(tests/fixtures/torch_smoke_utts.npz, tools/synth_corpus renderings of
dataset/manifest.test sentences) and, for training, the training fixture's
batch of eight (tests/fixtures/torch_train_batch.npz). On the CPU, in
float32 with ``jax_default_matmul_precision`` highest, for each family
``<f>`` in ``FAMILIES``:

- ``<f>_<path>`` greedy texts with ``_ids``, ``_margins`` and ``_frames``
  (per-frame argmax, top-2 log-prob margin, frame counts, as
  ``make_torch_smoke_fixture.PosteriorRecorder`` packs them) for the paths
  ``offline`` (``predict``), ``stream`` (``predict_stream`` in 0.16 s
  pieces, device frontend), ``batch`` (``predict_batch`` over
  ``batch_utts``, device frontend) and ``engine``
  (``StreamingBatchEngine(max_streams=4)``, three staggered streams);
- ``<f>_logprobs``: the first ``N_ROWS`` frames of the CTC log-probs of
  the first utterance (``get_ctc_log_probs`` on the host features);
- ``<f>_rescore`` and ``_rescore_scores`` (Squeezeformer and
  EfficientConformer): ``predict`` with attention rescoring at
  ``RESCORE_CONF`` on the three utterances;
- ``<f>_loss``, ``_loss_ctc``, ``_loss_att`` (0 for DeepSpeech2) and
  ``_grad_norm``: the step-0 loss terms and global gradient norm over the
  training batch, features from ``fbank_jax`` without dither, the model
  ``deterministic`` (no dropout, full context).

    JAX_PLATFORMS=cpu python tests/make_torch_zoo_fixture.py
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tests'))
import make_torch_smoke_fixture as fx  # noqa: E402
import make_torch_train_fixture as tf  # noqa: E402

OUT = os.path.join(ROOT, 'tests', 'fixtures', 'torch_zoo.npz')
SEED = 20261017
FAMILIES = {'deepspeech2': 'deepspeech2.yml',
            'squeezeformer': 'squeezeformer.yml',
            'efficient_conformer': 'efficient_conformer.yml'}
RESCORED = ('squeezeformer', 'efficient_conformer')
PATHS = ('offline', 'stream', 'batch', 'engine')
LOGIT_SCALE = 4.0
N_ROWS = 4
# attention rescoring without a language model, a small beam
RESCORE_CONF = dict(alpha=0.0, beta=0.0, beam_size=10, cutoff_prob=1.0,
                    cutoff_top_n=10, language_model_path=None)

# Tolerances of the port against these numbers:
# - CTC log-probs, float32 (under ieee_float32 on the card): max |Δ| over
#   the stored rows; the flagship's tolerance (tests/test_torch_flagship.py);
LOGPROB_TOL = 1e-3
# - the near-tie rule: a frame's argmax may differ from JAX's only where
#   JAX's top-2 log-prob margin is below this (two log-probs that each move
#   by LOGPROB_TOL can swap), and a text only through such frames;
NEAR_TIE = 2 * LOGPROB_TOL
# - attention rescoring: |Δscore| (a sum of a hypothesis' token log-probs
#   and its weighted CTC score, some 20 terms of LOGPROB_TOL each);
RESCORE_TOL = 2e-2
# - training, float32: the loss terms and the gradient norm, relative, as
#   the flagship's (make_torch_train_fixture.F32_RTOL).
TRAIN_RTOL = 1e-3


def config(use_model: str):
    """The family's committed config (``load_config``)."""
    from ppasr_tpu_torch.config import load_config
    return load_config(os.path.join(ROOT, 'configs', FAMILIES[use_model]))


def fill_weights(model: torch.nn.Module, seed: int = SEED,
                 gain: float = 1.0):
    """Every floating parameter and buffer of ``model`` drawn from
    ``np.random.default_rng(seed)`` in sorted-name order: weights N(0, 1)
    ×``gain`` over sqrt(fan in) (the CTC projection ×LOGIT_SCALE instead),
    embeddings N(0, 1),
    LayerNorm and BatchNorm scales and ``ada_scale`` 1 + N(0, 0.1²),
    running variances U(0.5, 1.5), everything else N(0, 0.1²). The biases
    torch has and flax's RNN cells lack stay zero
    (``models/deepspeech2._hold_second_bias``)."""
    rng = np.random.default_rng(seed)
    modules = dict(model.named_modules())
    state = model.state_dict()
    for name in sorted(state):
        t = state[name]
        if not t.is_floating_point():
            continue
        mod_name, _, leaf = name.rpartition('.')
        m = modules[mod_name]
        shape = tuple(t.shape)
        if leaf == 'running_var':
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == 'ada_scale' or (leaf == 'weight' and not isinstance(
                m, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d,
                    torch.nn.Embedding))):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif isinstance(m, torch.nn.Embedding):
            v = rng.standard_normal(shape)
        elif leaf == 'weight' or leaf.startswith('weight_'):
            v = rng.standard_normal(shape) / np.sqrt(t[0].numel())
            v = v * (LOGIT_SCALE if mod_name.endswith('ctc_lo') else gain)
        else:
            v = 0.1 * rng.standard_normal(shape)
        if isinstance(m, torch.nn.LSTM) and leaf == 'bias_ih_l0':
            v = np.zeros(shape)
        if isinstance(m, torch.nn.GRU) and leaf == 'bias_hh_l0':
            v[:2 * m.hidden_size] = 0.0
        state[name] = torch.from_numpy(v.astype(np.float32))
    model.load_state_dict(state, strict=True)
    return model


def zoo_model(use_model: str, seed: int = SEED, **overrides):
    """The family at its config's full width on the CPU, float32, weights
    from ``fill_weights``; ``overrides`` update its encoder and decoder
    confs (for the tests' dropout-free builds)."""
    from ppasr_tpu_torch.models.factory import build_model
    conf = config(use_model)
    enc = dict(conf.get('encoder_conf') or {})
    dec = dict(conf.get('decoder_conf') or {})
    enc.update(overrides.get('encoder_conf', {}))
    dec.update(overrides.get('decoder_conf', {}))
    model = build_model(use_model, 80, len(fx.vocabulary()),
                        streaming=bool(conf.get('streaming', True)),
                        encoder_conf=enc, decoder_conf=dec,
                        model_conf=dict(conf.get('model_conf') or {}),
                        mean_istd_path=os.path.join(ROOT, 'dataset',
                                                    'mean_istd.json'))
    return fill_weights(model, seed), conf


def zoo_artifact(use_model: str, out_dir: str, seed: int = SEED) -> str:
    """An exported-model directory for the family with ``fill_weights``'
    parameters: ``model.msgpack`` written by ``save_msgpack(export_params
    (...))`` beside the config's ``inference.json``."""
    from ppasr_tpu_torch.utils.checkpoint import (export_params, save_msgpack,
                                                  write_inference_artifact)
    os.makedirs(out_dir, exist_ok=True)
    model, conf = zoo_model(use_model, seed)
    weights = os.path.join(out_dir, 'weights.msgpack')
    save_msgpack(weights, export_params(model))
    return write_inference_artifact(
        out_dir, conf, weights, os.path.join(ROOT, 'dataset',
                                             'vocabulary.txt'),
        os.path.join(ROOT, 'dataset', 'mean_istd.json'))


def pcms():
    """The smoke fixture's three int16 utterances."""
    data = np.load(fx.OUT)
    return np.split(data['pcm'], np.cumsum(data['lengths'])[:-1])


def path_runs(pred, engine_cls, utts):
    """{path: () → greedy texts} for the four paths of ``PATHS``, given a
    predictor built with the device frontend."""
    return {
        'offline': lambda: [pred.predict(p)['text'] for p in utts],
        'stream': lambda: [fx.stream_text(pred, p) for p in utts],
        'batch': lambda: [r['text'] for r in pred.predict_batch(
            fx.batch_utts(utts))],
        'engine': lambda: fx.engine_texts(engine_cls(pred, max_streams=4),
                                          utts),
    }


def frame_failures(got_texts, got_utts, want_texts, want_ids,
                   want_margins, frames, tol=NEAR_TIE):
    """The near-tie rule over every frame: for each utterance the same
    frame count as JAX's, an argmax equal to JAX's at every frame whose JAX
    top-2 margin is at least ``tol``, and the same text unless some argmax
    differs. ``got_utts`` are ``PosteriorRecorder.utts``; the rest as the
    fixture packs them. → list of failures (empty when the rule holds)."""
    bad, start = [], 0
    for i, n in enumerate(np.asarray(frames)):
        n = int(n)
        w, m = np.asarray(want_ids)[start:start + n], \
            np.asarray(want_margins)[start:start + n]
        start += n
        g = np.asarray(got_utts[i][0])
        if g.shape != w.shape:
            bad.append((i, f'{len(g)} frames, JAX {n}'))
            continue
        off = np.nonzero(g != w)[0]
        if (m[off] >= tol).any():
            bad.append((i, f'frames {off.tolist()} margins '
                           f'{m[off].tolist()}'))
        elif not len(off) and got_texts[i] != want_texts[i]:
            bad.append((i, f'text {got_texts[i]!r}, JAX {want_texts[i]!r} '
                           f'with every argmax equal'))
    return bad


def main():
    import jax
    jax.config.update('jax_default_matmul_precision', 'highest')
    import jax.numpy as jnp
    import tempfile
    import ppasr_tpu.decoders.greedy as greedy
    import ppasr_tpu.predict as predict
    from ppasr_tpu.models.factory import build_model
    from ppasr_tpu.ops.fbank import fbank_jax
    from ppasr_tpu.serving import StreamingBatchEngine
    from ppasr_tpu_torch.utils.checkpoint import export_params

    utts = pcms()
    wav, wav_lens, text, text_lens = tf.batch(tf.load())
    out = {'seed': np.array(SEED)}
    for use_model in FAMILIES:
        with tempfile.TemporaryDirectory() as tmp:
            artifact = zoo_artifact(use_model, tmp)
            pred = predict.PPASRPredictor(model_path=artifact,
                                          use_device_frontend=True)
            for path, run in path_runs(pred, StreamingBatchEngine,
                                       utts).items():
                with fx.PosteriorRecorder(predict, greedy) as rec:
                    texts = run()
                ids, margins, frames = rec.pack(len(texts))
                key = f'{use_model}_{path}'
                out.update({key: np.array(texts),
                            key + '_ids': ids.astype(np.int16),
                            key + '_margins': margins,
                            key + '_frames': frames})
            x, lens = fx.host_features(pred, utts[:1])
            lp, _ = pred.model.apply(pred.params, jnp.asarray(x),
                                     jnp.asarray(lens),
                                     method='get_ctc_log_probs')
            out[f'{use_model}_logprobs'] = np.asarray(lp[0, :N_ROWS])
            nonblank = np.mean(out[f'{use_model}_offline_ids'] != 0)
            print(use_model, 'non-blank frames', nonblank)
            del pred
            if use_model in RESCORED:
                res = predict.PPASRPredictor(
                    model_path=artifact, decoder='attention_rescoring',
                    decoder_configs=dict(RESCORE_CONF))
                results = [res.predict(p) for p in utts]
                out[f'{use_model}_rescore'] = np.array(
                    [r['text'] for r in results])
                out[f'{use_model}_rescore_scores'] = np.array(
                    [r['score'] for r in results], np.float32)
                del res
        out.update(train_keys(use_model, wav, wav_lens, text, text_lens,
                              build_model, fbank_jax, export_params))
    np.savez_compressed(OUT, **out)
    print(OUT, os.path.getsize(OUT), 'bytes')
    for k, v in out.items():
        if v.dtype.kind in 'U' or v.ndim == 0:
            print(k, v.tolist())


def train_keys(use_model, wav, wav_lens, text, text_lens, build_model,
               fbank_jax, export_params):
    """The JAX model's step-0 loss terms and gradient norm (float32,
    deterministic) over the training batch with ``fill_weights``'
    parameters."""
    import jax
    import jax.numpy as jnp
    model, conf = zoo_model(use_model)
    jm = build_model(use_model, 80, len(fx.vocabulary()),
                     streaming=bool(conf.get('streaming', True)),
                     encoder_conf=dict(conf.get('encoder_conf') or {}),
                     decoder_conf=dict(conf.get('decoder_conf') or {}),
                     model_conf=dict(conf.get('model_conf') or {}),
                     mean_istd_path=os.path.join(ROOT, 'dataset',
                                                 'mean_istd.json'))
    variables = jax.tree.map(jnp.asarray, export_params(model))
    feat, feat_lens = fbank_jax(jnp.asarray(wav, jnp.float32),
                                jnp.asarray(wav_lens))

    def loss_fn(params):
        o = jm.apply(dict(variables, params=params), feat, feat_lens,
                     jnp.asarray(text), jnp.asarray(text_lens),
                     deterministic=True)
        return o['loss'], o
    (_, o), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables['params'])
    norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                              for g in jax.tree.leaves(grads))))
    out = {f'{use_model}_grad_norm': np.array(norm, np.float32)}
    for k in ('loss', 'loss_ctc', 'loss_att'):
        v = o[k]
        out[f'{use_model}_{k}'] = np.array(0.0 if v is None else float(v),
                                           np.float32)
    return out


if __name__ == '__main__':
    main()
