"""A tiny exported streaming-Conformer artifact for the port's parity tests
(``inference.json`` in the format of ppasr_tpu/trainer.py:919-930,
``model.msgpack`` written by flax from a seeded init, the vocabulary and
``mean_istd.json``), and the speech-like int16 PCM those tests decode.

The artifact's CMVN is computed from the features of synthetic speech, as
a trained model's is from its corpus, so the untrained encoder's output
varies over time and the decoded texts are many characters long. Imports
JAX: only the tests that compare the two packages use it."""
import json

import jax
import jax.numpy as jnp
import numpy as np
from flax import serialization

from ppasr_tpu.data.audio import AudioSegment as JaxSegment
from ppasr_tpu.models.conformer import ConformerModel as JaxConformer
from ppasr_tpu.ops.fbank import fbank_numpy

D = 80
CHARS = list('abcdefghijklmnopqrstuvwxyz') + ['<space>']
VOCAB = ['<blank>', '<unk>'] + CHARS + ['<eos>']
ENC = dict(output_size=64, attention_heads=4, linear_units=128, num_blocks=2,
           cnn_module_kernel=15, block_final_norm=False)
DEC = dict(attention_heads=4, linear_units=64, num_blocks=1, r_num_blocks=1)


def speechlike(n_samples, seed):
    """int16 PCM at 16 kHz: harmonics of a gliding pitch under a syllable-
    rate envelope, with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    f0 = 110 + 60 * np.sin(2 * np.pi * 0.9 * t + seed)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    voiced = sum(np.sin(k * phase) * rng.uniform(0.2, 1.0) / k
                 for k in range(1, 15))
    env = np.clip(np.sin(2 * np.pi * 3.1 * t) ** 2 + 0.1 * rng.standard_normal(
        n_samples), 0, 1)
    x = 0.3 * env * voiced + 0.01 * rng.standard_normal(n_samples)
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def write_artifact(out):
    """Write the tiny artifact into the directory ``out`` (a Path); returns
    it as a str."""
    write_vocab_and_cmvn(out)
    model = JaxConformer(input_size=D, vocab_size=len(VOCAB), streaming=True,
                         encoder_conf=ENC, decoder_conf=DEC)
    key = jax.random.PRNGKey(3)
    params = model.init({'params': key, 'dropout': key, 'chunk': key},
                        jnp.zeros((1, 64, D)), jnp.asarray([64]),
                        jnp.asarray([[1, 2]]), jnp.asarray([2]),
                        deterministic=True)
    params = jax.tree.map(np.asarray, params)
    with open(out / 'model.msgpack', 'wb') as f:
        f.write(serialization.to_bytes(params))
    with open(out / 'inference.json', 'w', encoding='utf-8') as f:
        json.dump({'use_model': 'conformer', 'streaming': True,
                   'input_dim': D, 'vocab_size': len(VOCAB),
                   'encoder_conf': ENC, 'decoder_conf': DEC,
                   'model_conf': {'ctc_weight': 0.3}}, f, indent=2)
    return str(out)


def write_vocab_and_cmvn(out):
    """The artifacts' ``vocabulary.txt`` and ``mean_istd.json`` (the CMVN
    of synthetic speech's features) in the directory ``out``."""
    with open(out / 'vocabulary.txt', 'w', encoding='utf-8') as f:
        f.write(''.join(f'{tok}\t1\n' for tok in VOCAB))
    feats = []
    for seed in (11, 12, 13):
        seg = JaxSegment(speechlike(32000, seed), 16000)
        seg.normalize(-20)
        feats.append(fbank_numpy(seg.to('int16').astype(np.float32)))
    feats = np.concatenate(feats)
    with open(out / 'mean_istd.json', 'w', encoding='utf-8') as f:
        json.dump({'mean': feats.mean(0).tolist(),
                   'istd': (1.0 / feats.std(0)).tolist()}, f)


def random_arpa(path, vocab, order, seed, n_per_order=120, absent=0):
    """Write a random well-formed ARPA file of ``order`` over the tokens
    ``vocab`` (the last ``absent`` of them left out of the model, so they
    score as unknown), with <s>, </s> and <unk> unigrams and backoff
    weights below the highest order; returns ``path`` as a str."""
    rng = np.random.default_rng(seed)
    toks = list(vocab[:len(vocab) - absent])
    grams = {1: [((t,), -rng.uniform(0.5, 4.0), -rng.uniform(0.1, 1.5))
                 for t in toks + ['<s>', '</s>', '<unk>']]}
    for n in range(2, order + 1):
        seen, grams[n] = set(), []
        for _ in range(n_per_order):
            ng = tuple(rng.choice(toks, n))
            if ng not in seen:
                seen.add(ng)
                grams[n].append((ng, -rng.uniform(0.1, 3.0),
                                 -rng.uniform(0.01, 0.6)))
    lines = ["\\data\\"] + [f"ngram {n}={len(grams[n])}"
                            for n in range(1, order + 1)] + [""]
    for n in range(1, order + 1):
        lines.append(f"\\{n}-grams:")
        for ng, p, b in grams[n]:
            lines.append(f"{p:.6f}\t{' '.join(ng)}"
                         + (f"\t{b:.6f}" if n < order else ""))
        lines.append("")
    lines.append("\\end\\")
    with open(path, 'w', encoding='utf-8') as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


# the model zoo at tiny widths, weights from make_torch_zoo_fixture's
# fill_weights: (encoder_conf, decoder_conf, model_conf) per family, and
# the weight gain of each (DeepSpeech2's LSTM at unit gain emits one token
# for every frame of these inputs; ×2 makes its argmax move)
ZOO_GAIN = {'deepspeech2': 2.0}
ZOO = {
    'deepspeech2': (dict(num_rnn_layers=2, rnn_size=64, use_gru=False),
                    {}, {}),
    'squeezeformer': (dict(encoder_dim=64, output_size=64, attention_heads=2,
                           num_blocks=4, reduce_idx=1, recover_idx=3,
                           feed_forward_expansion_factor=2,
                           cnn_module_kernel=7),
                      DEC, {'ctc_weight': 0.3}),
    'efficient_conformer': (dict(output_size=64, attention_heads=2,
                                 linear_units=128, num_blocks=3,
                                 cnn_module_kernel=15, block_final_norm=False,
                                 efficient_conf=dict(
                                     stride_layer_idx=[1], stride=[2],
                                     group_layer_idx=[0, 1], group_size=3)),
                            DEC, {'ctc_weight': 0.3}),
}


def write_zoo_artifact(out, use_model, seed=5, **encoder_overrides):
    """``write_artifact`` for a tiny ``use_model`` of ``ZOO`` (or the
    Conformer of ``ENC``/``DEC``), its encoder config updated with
    ``encoder_overrides``: the port builds it, ``fill_weights`` draws its
    parameters and ``export_params`` writes them
    (``utils/checkpoint.save_msgpack``) for both packages, with no flax
    init."""
    from make_torch_zoo_fixture import fill_weights
    from ppasr_tpu_torch.models.factory import build_model
    from ppasr_tpu_torch.utils.checkpoint import export_params, save_msgpack
    write_vocab_and_cmvn(out)
    enc, dec, model_conf = dict(
        ZOO, conformer=(ENC, DEC, {'ctc_weight': 0.3}))[use_model]
    enc = dict(enc, **encoder_overrides)
    model = build_model(use_model, D, len(VOCAB), streaming=True,
                        encoder_conf=enc, decoder_conf=dec,
                        model_conf=model_conf)
    fill_weights(model, seed, ZOO_GAIN.get(use_model, 1.0))
    save_msgpack(str(out / 'model.msgpack'), export_params(model))
    with open(out / 'inference.json', 'w', encoding='utf-8') as f:
        json.dump({'use_model': use_model, 'streaming': True,
                   'input_dim': D, 'vocab_size': len(VOCAB),
                   'encoder_conf': enc, 'decoder_conf': dec,
                   'model_conf': model_conf}, f, indent=2)
    return str(out)
