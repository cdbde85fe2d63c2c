"""Write tests/fixtures/torch_train_batch.npz: eight synthetic utterances and
the JAX package's training numbers on them with the committed flagship
checkpoint, for the port's full-width training checks
(tests/test_torch_flagship_train.py on the CPU, chip_smoke.py's train phase
on the card). Only ``main`` imports JAX; the helpers below need numpy alone.

The PCM is rendered by tools/synth_corpus.synth_utterance from sentences
4–11 of dataset/manifest.test with one np.random.default_rng(SEED) used in
order, as int16. ``batch`` pads it into one raw batch the way
``collate_raw_fn`` does (samples rounded up to 64·160, labels to 16, padded
with −1).

The JAX numbers, on the CPU in float32 (``jax_default_matmul_precision``
highest), the features from ``fbank_jax`` without dither, the model in
``deterministic`` mode (no dropout, the full context):

- ``f32_*`` / ``bf16_*``: loss, loss_ctc, loss_att, th_accuracy and the
  global gradient norm of the loss over all eight utterances at once, with
  the model's dtype float32 or bfloat16 (parameters float32);
- ``update_losses``: the flagship's optax chain (clip 5 → adamw, WarmupLR
  peak 1e-3 over 1,000 steps, weight decay 1e-6) takes 3 updates with
  accum_grad 2 (rows 0–3 and 4–7, gradients summed and halved); after each,
  the mean of the two micro-batches' losses;
- ``update_norm``: the global norm of the parameters' change after the 3
  updates.

    JAX_PLATFORMS=cpu python tests/make_torch_train_fixture.py
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'tests', 'fixtures', 'torch_train_batch.npz')
CONFIG = os.path.join(ROOT, 'configs', 'campaign', 'conformer_synth.yml')
CHECKPOINT = os.path.join(ROOT, 'models', 'conformer_streaming_fbank',
                          'best_model', 'model.msgpack')
SEED = 20261017
FIRST, N_UTTS = 3, 8          # sentences 4–11 of dataset/manifest.test
ACCUM, MICRO = 2, 4
N_UPDATES = 3
SAMPLE_BUCKET = 64 * 160      # collate_raw_fn's
LABEL_BUCKET = 16

# Tolerances of the port against these numbers, each |port − JAX| ≤
# rtol·|JAX| (th_accuracy: an absolute bound):
# - float32 on the CPU and on the card (under ieee_float32): the two
#   frameworks sum the same products in other orders through 12 + 6 blocks;
#   the tiny-width tests agree to 1e-5 relative, and the full width adds
#   depth and longer sums: 1e-3 leaves an order of magnitude of margin;
F32_RTOL = 1e-3
# - th_accuracy counts argmax hits over the batch's tokens; a near-tie can
#   flip one of them: one token of the batch's LABEL tokens (set by the
#   checks from the token count) is the bound, in float32 and bfloat16;
# - bfloat16: each framework rounds to 8 bits of mantissa at other places
#   (flax casts per layer; the port casts at use in the same layers, but
#   the reductions of bf16 products differ); the tiny-width loss agrees to
#   0.2 %, and the full width compounds it over 18 blocks: the port's bf16
#   on the CPU read loss_ctc 1.9e-2 from JAX's (the inference bf16
#   log-probs of the two differ by up to 0.66, tests/test_torch_bf16.py):
#   5e-2 for the loss terms and 1e-1 for the gradient norm, whose small
#   terms are the noisiest;
BF16_LOSS_RTOL = 5e-2
BF16_GRAD_NORM_RTOL = 1e-1
# - the 3 updates: float32, the same as step 0 (AdamW's update is
#   normalized, so an lr or bias-correction fault moves update_norm by far
#   more than this).
UPDATE_RTOL = 1e-3


def sentences():
    with open(os.path.join(ROOT, 'dataset', 'manifest.test'),
              encoding='utf-8') as f:
        lines = [json.loads(line)['text'] for line in f if line.strip()]
    return lines[FIRST:FIRST + N_UTTS]


def render(texts, seed=SEED):
    """texts → list of int16 PCM arrays (synth_corpus.write_wav's scaling)."""
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    from synth_corpus import synth_utterance
    rng = np.random.default_rng(seed)
    return [(np.clip(synth_utterance(t, rng), -1.0, 1.0) * 32767.0)
            .astype('<i2') for t in texts]


def load():
    return np.load(OUT)


def pcms(data):
    """The eight int16 utterances of the fixture."""
    ends = np.cumsum(data['pcm_lens'])
    return [data['pcm'][e - n:e] for e, n in zip(ends, data['pcm_lens'])]


def batch(data):
    """(wav [8, S] int16, wav_lens [8] int64, text [8, U] int32 padded with
    −1, text_lens [8] int64), padded as ``collate_raw_fn`` pads."""
    utts = pcms(data)
    s = -(-max(len(p) for p in utts) // SAMPLE_BUCKET) * SAMPLE_BUCKET
    wav = np.zeros((len(utts), s), np.int16)
    for i, p in enumerate(utts):
        wav[i, :len(p)] = p
    return (wav, data['pcm_lens'].astype(np.int64), data['tokens'],
            data['token_lens'].astype(np.int64))


def micro_batches(arrays):
    """[8, ...] arrays → [ACCUM, MICRO, ...]."""
    return [a.reshape(ACCUM, MICRO, *a.shape[1:]) for a in arrays]


def main():
    import jax
    import jax.numpy as jnp
    import optax

    jax.config.update('jax_default_matmul_precision', 'highest')
    from ppasr_tpu.config import load_config
    from ppasr_tpu.data.featurizer.text_featurizer import TextFeaturizer
    from ppasr_tpu.models.factory import build_model
    from ppasr_tpu.ops.fbank import fbank_jax
    from ppasr_tpu.optimizer.factory import build_optimizer
    from ppasr_tpu_torch.utils.checkpoint import load_msgpack

    texts = sentences()
    utts = render(texts)
    featurizer = TextFeaturizer(os.path.join(ROOT, 'dataset',
                                             'vocabulary.txt'))
    ids = [featurizer.featurize(t) for t in texts]
    u = -(-max(len(t) for t in ids) // LABEL_BUCKET) * LABEL_BUCKET
    tokens = np.full((N_UTTS, u), -1, np.int32)
    for i, t in enumerate(ids):
        tokens[i, :len(t)] = t
    out = dict(pcm=np.concatenate(utts),
               pcm_lens=np.asarray([len(p) for p in utts], np.int64),
               tokens=tokens,
               token_lens=np.asarray([len(t) for t in ids], np.int64),
               texts=np.asarray(texts), seed=np.int64(SEED))

    wav, wav_lens, text, text_lens = batch(out)
    feat, feat_lens = fbank_jax(jnp.asarray(wav, jnp.float32),
                                jnp.asarray(wav_lens))
    conf = load_config(CONFIG)
    params = jax.tree.map(jnp.asarray, load_msgpack(CHECKPOINT))

    def model_of(dtype):
        return build_model(
            'conformer', 80, featurizer.vocab_size, streaming=True,
            encoder_conf=dict(conf.encoder_conf),
            decoder_conf=dict(conf.decoder_conf),
            model_conf=dict(conf.model_conf),
            mean_istd_path=os.path.join(ROOT, 'dataset', 'mean_istd.json'),
            dtype=dtype)

    def terms(model, p, x, xl, t, tl):
        o = model.apply(p, x, xl, t, tl, deterministic=True)
        return o['loss'], o

    for name, dtype in (('f32', jnp.float32), ('bf16', jnp.bfloat16)):
        model = model_of(dtype)
        (_, o), g = jax.jit(jax.value_and_grad(
            lambda p: terms(model, p, feat, feat_lens, jnp.asarray(text),
                            jnp.asarray(text_lens)), has_aux=True))(params)
        for k in ('loss', 'loss_ctc', 'loss_att', 'th_accuracy'):
            out[f'{name}_{k}'] = np.float64(o[k])
        out[f'{name}_grad_norm'] = np.float64(optax.global_norm(g))
        print(name, {k: float(out[f'{name}_{k}']) for k in
                     ('loss', 'loss_ctc', 'loss_att', 'th_accuracy',
                      'grad_norm')}, flush=True)

    model = model_of(jnp.float32)
    tx, _ = build_optimizer(dict(conf.optimizer_conf),
                            grad_clip=float(conf.train_conf.grad_clip))
    mb = micro_batches([np.asarray(feat), np.asarray(feat_lens), text,
                        text_lens])
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, x, xl, t, tl: terms(model, p, x, xl, t, tl)[0]))
    loss_fn = jax.jit(lambda p, x, xl, t, tl: terms(model, p, x, xl, t,
                                                     tl)[0])
    p, opt_state, losses = params, tx.init(params), []
    for _ in range(N_UPDATES):
        acc = jax.tree.map(jnp.zeros_like, p)
        for i in range(ACCUM):
            _, g = grad_fn(p, *(jnp.asarray(a[i]) for a in mb))
            acc = jax.tree.map(jnp.add, acc, g)
        acc = jax.tree.map(lambda a: a / ACCUM, acc)
        updates, opt_state = tx.update(acc, opt_state, p)
        p = optax.apply_updates(p, updates)
        losses.append(np.mean([float(loss_fn(p, *(jnp.asarray(a[i])
                                                  for a in mb)))
                               for i in range(ACCUM)]))
        print('update', len(losses), losses[-1], flush=True)
    out['update_losses'] = np.asarray(losses, np.float64)
    out['update_norm'] = np.float64(optax.global_norm(
        jax.tree.map(jnp.subtract, p, params)))
    print('update_norm', float(out['update_norm']))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == '__main__':
    main()
