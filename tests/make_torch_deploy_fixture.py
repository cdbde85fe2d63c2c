"""Write tests/fixtures/torch_deploy.npz: the JAX package's outputs for the
port's deployment path (seeds, texts and digests; no weights), read by the
card check (chip_smoke.py's deploy phase) and the card tests
(tests/test_torch_deploy_cuda.py). The CPU tests share this module's
helpers; only ``main`` imports JAX.

- ``jax_quant_digest``: ``quant_digest`` of the committed flagship
  quantized by ``ppasr_tpu.utils.quant.quantize_params`` and dequantized by
  its ``dequantize_params``: the port's must be the same bits;
- ``jax_quant_offline``, ``jax_quant_stream``: the JAX ``PPASRPredictor``
  served from that ``model_quant.msgpack`` alone (``quant_artifact``) on
  the device frontend, greedy, on the smoke fixture's three utterances:
  ``predict`` and ``predict_stream`` in 0.16 s pieces;
- ``jax_program_offline``, ``jax_program_chunks``: the JAX
  ``InferencePredictor`` of the flagship (its model code, which its
  StableHLO programs reproduce) on the utterances' host features, greedy:
  ``predict`` on each, and ``predict_chunk_conformer`` over
  ``chunk_windows``;
- ``vad_seed``, ``vad_windows_seed``, ``jax_vad_probs``: the JAX
  ``VADModel`` with ``vad_params(vad_seed)`` over two calls on
  ``vad_windows`` (the LSTM's carry crossing from the first to the
  second).

    JAX_PLATFORMS=cpu python tests/make_torch_deploy_fixture.py
"""
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

import make_torch_smoke_fixture as fx

ROOT = fx.ROOT
OUT = os.path.join(ROOT, 'tests', 'fixtures', 'torch_deploy.npz')
FLAGSHIP = os.path.join(ROOT, 'models', 'conformer_streaming_fbank',
                        'best_model', 'model.msgpack')
VAD_SEED = 20261017
VAD_WINDOWS_SEED = 7
VAD_WINDOWS = (9, 7)        # windows in the first call, in the second
VAD_TOL = 1e-5              # |Δ probability| against JAX's VADModel
CHUNK_WINDOW, CHUNK_STRIDE = 67, 64
# posteriors of the exported programs against the port's own model code on
# the card (TF32 off) and against JAX's get_encoder_out on the CPU
PROGRAM_TOL = 1e-5
# DeepSpeech2 against JAX: the port's LSTM against flax's cell, as
# tests/test_torch_deepspeech2.py holds them
PROGRAM_JAX_TOL = {'deepspeech2': 1e-4}
# DeepSpeech2's programs (their RNNs unpacked) against its packed model
# code: up to 7.2e-6 on the CPU (a batch of ragged rows runs in shrinking
# groups) and 2.0e-5 on the card at small widths (cuDNN's packed kernel,
# also for one full row)
DS2_PACKED_TOL = 1e-4
# against the port's model code on the CPU at the program's padded length
# (DeepSpeech2's run unpacked): the same operations on the same layouts
PROGRAM_CODE_TOL = 1e-6


def quant_digest(tree) -> str:
    """sha256 over every leaf of a numpy tree, in sorted path order: each
    '/'-joined path, dtype, shape and bytes."""
    h = hashlib.sha256()

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, prefix + (str(k),))
            else:
                a = np.ascontiguousarray(v)
                h.update('/'.join(prefix + (str(k),)).encode())
                h.update(f'{a.dtype.str}{a.shape}'.encode())
                h.update(a.tobytes())
    walk(tree, ())
    return h.hexdigest()


def quant_artifact(out_dir, write_quant):
    """An exported directory of the flagship with ``model_quant.msgpack``
    and no ``model.msgpack``: the flagship's ``inference.json``, vocabulary
    and CMVN beside the int8 file that ``write_quant(path)`` writes."""
    fx.flagship_artifact(out_dir)
    os.remove(os.path.join(out_dir, 'model.msgpack'))
    write_quant(os.path.join(out_dir, 'model_quant.msgpack'))
    return out_dir


def chunk_windows(feat):
    """[T, D] features → the [1, 67, D] windows at stride 64 that fit."""
    return [feat[None, s:s + CHUNK_WINDOW]
            for s in range(0, feat.shape[0] - CHUNK_WINDOW + 1, CHUNK_STRIDE)]


def vad_params(seed=VAD_SEED):
    """The flax parameter tree of the JAX ``VADModel`` (4 convs, Dense(64),
    an OptimizedLSTMCell(64), Dense(1)), drawn from ``seed``: kernels
    N(0, 1)·gain over sqrt(fan in) (gain 2 for the convs, 3 into the LSTM,
    4 out of it, so that the probabilities spread), biases N(0, 0.5²)."""
    rng = np.random.default_rng(seed)

    def w(shape, fan_in, gain):
        return (gain * rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def b(n):
        return (0.5 * rng.standard_normal(n)).astype(np.float32)

    p, ch = {}, 1
    for i, feat in enumerate((16, 32, 48, 64)):
        p[f'Conv_{i}'] = {'bias': b(feat), 'kernel': w((5, ch, feat),
                                                       5 * ch, 2)}
        ch = feat
    p['Dense_0'] = {'bias': b(64), 'kernel': w((4 * ch, 64), 4 * ch, 3)}
    p['Dense_1'] = {'bias': b(1), 'kernel': w((64, 1), 64, 4)}
    cell = {}
    for g in 'ifgo':
        cell['h' + g] = {'bias': b(64), 'kernel': w((64, 64), 64, 1)}
        cell['i' + g] = {'kernel': w((64, 64), 64, 3)}
    p['OptimizedLSTMCell_0'] = cell
    return {'params': p}


def vad_windows(seed=VAD_WINDOWS_SEED):
    """The two calls' [N, 512] windows: quiet, then a speech-like
    signal."""
    rng = np.random.default_rng(seed)
    n = sum(VAD_WINDOWS)
    x = fx.speechlike(n * 512, seed) / 8192.0
    x[: 3 * 512] = 0.004 * rng.standard_normal(3 * 512)
    windows = x.reshape(n, 512).astype(np.float32)
    return windows[:VAD_WINDOWS[0]], windows[VAD_WINDOWS[0]:]


def write_vad_model(model_dir, save_msgpack, seed=VAD_SEED):
    """``model_dir/vad_model.msgpack`` of ``vad_params(seed)``, written by
    the given writer (flax's ``to_bytes`` or the port's)."""
    os.makedirs(model_dir, exist_ok=True)
    save_msgpack(os.path.join(model_dir, 'vad_model.msgpack'),
                 vad_params(seed))
    return model_dir


def main():
    sys.path.insert(0, ROOT)
    from flax import serialization
    from ppasr_tpu.decoders.greedy import greedy_decoder
    from ppasr_tpu.infer_utils.inference_predictor import InferencePredictor
    from ppasr_tpu.infer_utils.vad_predictor import VADModel
    from ppasr_tpu.predict import PPASRPredictor
    from ppasr_tpu.utils.quant import dequantize_params, quantize_params

    def flax_save(path, tree):
        with open(path, 'wb') as f:
            f.write(serialization.to_bytes(tree))

    data = np.load(fx.OUT)
    pcms = np.split(data['pcm'], np.cumsum(data['lengths'])[:-1])
    with open(FLAGSHIP, 'rb') as f:
        params = serialization.msgpack_restore(f.read())
    blob = quantize_params(params)
    out = {'jax_quant_digest': np.array(quant_digest(
        dequantize_params(blob, params)))}
    with tempfile.TemporaryDirectory() as tmp:
        qdir = quant_artifact(os.path.join(tmp, 'quant'),
                              lambda p: flax_save(p, blob))
        pred = PPASRPredictor(model_path=qdir, use_device_frontend=True)
        out['jax_quant_offline'] = np.array([pred.predict(p)['text']
                                             for p in pcms])
        out['jax_quant_stream'] = np.array([fx.stream_text(pred, p)
                                            for p in pcms])
        art = fx.flagship_artifact(os.path.join(tmp, 'flagship'))
        host = PPASRPredictor(model_path=art)
        infer = InferencePredictor(
            art, mean_istd_path=os.path.join(art, 'mean_istd.json'),
            use_stablehlo=False)
        offline, chunks = [], []
        for p in pcms:
            feat = host.audio_featurizer.featurize(host._load_audio(p))
            probs, olens = infer.predict(feat[None],
                                         np.array([feat.shape[0]]))
            offline.append(greedy_decoder(probs[0, :int(olens[0])],
                                          host.vocab_list)[1])
            infer.reset_stream()
            posts = [infer.predict_chunk_conformer(w)[0]
                     for w in chunk_windows(feat)]
            chunks.append(greedy_decoder(np.concatenate(posts),
                                         host.vocab_list)[1])
        out['jax_program_offline'] = np.array(offline)
        out['jax_program_chunks'] = np.array(chunks)
        vad_dir = write_vad_model(os.path.join(tmp, 'vad'), flax_save)
        vad = VADModel(vad_dir)
        first, second = vad_windows()
        out['jax_vad_probs'] = np.concatenate([vad(first), vad(second)])
    out.update(vad_seed=np.array(VAD_SEED),
               vad_windows_seed=np.array(VAD_WINDOWS_SEED))
    np.savez(OUT, **out)
    for k, v in out.items():
        print(k, json.dumps(v.tolist(), ensure_ascii=False)[:200])


if __name__ == '__main__':
    main()
