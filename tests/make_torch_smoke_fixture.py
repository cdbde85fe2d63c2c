"""Write tests/fixtures/torch_smoke_utts.npz: three synthetic utterances and
the JAX package's flagship transcripts of them, for the port's flagship
test (tests/test_torch_flagship.py) and its card check (chip_smoke.py).
Those two, and the fbank tests, also share this module's helpers; only
``main`` imports JAX.

The PCM is rendered by tools/synth_corpus.synth_utterance from the first
three sentences of dataset/manifest.test with one np.random.default_rng(SEED)
used in order, then stored as int16 the way synth_corpus.write_wav stores
it. The transcripts come from the JAX package on the CPU with the committed
flagship checkpoint and greedy decoding:

- ``jax_offline``, ``jax_stream``: ``PPASRPredictor.predict``, and
  ``predict_stream`` in 0.16 s pieces with the device frontend (the Pallas
  fbank in interpret mode);
- ``jax_batch``, ``jax_batch_device``: ``predict_batch`` over
  ``batch_utts`` (the three utterances and two cuts of them) on the host
  frontend and on the device frontend (``fbank_jax``);
- ``jax_engine``: ``serving.StreamingBatchEngine(max_streams=4)`` fed by
  ``engine_texts`` (0.16 s pieces, interleaved, staggered);
- ``jax_stream_eval``: ``models.streaming_eval.streaming_greedy_batch`` over
  the three utterances' host features (``host_features``);
- the flagship's beam search at its configured width (``beam_conf``: beam
  300, ``cutoff_top_n`` 40, ``cutoff_prob`` 0.99, α 0.8, β 1.0 and the
  trigram ``lm/synth_lm.arpa``, which the JAX decoder fuses through its hash
  tables), each key with a ``*_scores`` array: ``jax_beam_offline``
  (``predict``), ``jax_beam_stream`` (``predict_stream`` in 0.16 s pieces,
  device frontend), ``jax_beam_batch_device`` (``predict_batch`` over
  ``batch_utts``, device frontend) and ``jax_beam_native`` (``predict`` with
  ``backend='native'``); ``beam_lm`` and ``beam_conf`` (JSON) store the LM's
  path in the repository and the rest of the configuration.

    JAX_PLATFORMS=cpu python tests/make_torch_smoke_fixture.py
"""
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'tests', 'fixtures', 'torch_smoke_utts.npz')
SEED = 20240607
N_UTTS = 3
PIECE = 2560          # 0.16 s at 16 kHz
# the flagship's beam search: configs/campaign/conformer_synth.yml
# ctc_beam_search_decoder_conf, its trigram LM by its path in the repository
BEAM_LM = 'lm/synth_lm.arpa'
BEAM_CONF = dict(alpha=0.8, beta=1.0, beam_size=300, num_processes=2,
                 cutoff_prob=0.99, cutoff_top_n=40)
# |Δscore| of a flagship beam result against the fixture's JAX score: the
# flagship's CTC log-prob tolerance (tests/test_torch_flagship.py)
BEAM_SCORE_TOL = 1e-3


def beam_conf(conf_json=None):
    """The flagship's ``decoder_configs``: BEAM_CONF (or the JSON stored in
    the fixture) with the LM's absolute path."""
    conf = dict(BEAM_CONF) if conf_json is None else json.loads(conf_json)
    conf['language_model_path'] = os.path.join(ROOT, BEAM_LM)
    return conf


def vocabulary():
    """dataset/vocabulary.txt's tokens, its first tab-separated column, as
    TextFeaturizer reads it."""
    with open(os.path.join(ROOT, 'dataset', 'vocabulary.txt'),
              encoding='utf-8') as f:
        return [line.split('\t')[0] for line in f.read().splitlines()]


def sentences(n=N_UTTS):
    with open(os.path.join(ROOT, 'dataset', 'manifest.test'),
              encoding='utf-8') as f:
        return [json.loads(next(f))['text'] for _ in range(n)]


def render(texts, seed=SEED):
    """texts → list of int16 PCM arrays (synth_corpus.write_wav's scaling)."""
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    from synth_corpus import synth_utterance
    rng = np.random.default_rng(seed)
    return [(np.clip(synth_utterance(t, rng), -1.0, 1.0) * 32767.0)
            .astype('<i2') for t in texts]


def speechlike(n_samples, seed=0):
    """Speech-like int16-scaled float32 signal: harmonics of a gliding pitch
    under a syllable-rate envelope, noise and a DC offset."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    voiced = sum(np.sin(k * phase) / k for k in range(1, 12))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4 * t) ** 2
    x = 6000 * env * voiced + 300 * rng.standard_normal(n_samples) + 150
    return np.clip(x, -32768, 32767).astype(np.float32)


def flagship_artifact(out_dir):
    """Exported-model directory for the committed flagship checkpoint."""
    from ppasr_tpu_torch.config import load_config
    from ppasr_tpu_torch.utils.checkpoint import write_inference_artifact
    return write_inference_artifact(
        out_dir, load_config(os.path.join(ROOT, 'configs', 'campaign',
                                          'conformer_synth.yml')),
        os.path.join(ROOT, 'models', 'conformer_streaming_fbank',
                     'best_model', 'model.msgpack'),
        os.path.join(ROOT, 'dataset', 'vocabulary.txt'),
        os.path.join(ROOT, 'dataset', 'mean_istd.json'))


def stream_result(pred, pcm, piece=PIECE):
    """Stream ``pcm`` through ``pred`` in pieces; the final result."""
    pred.reset_stream()
    out = None
    for i in range(0, len(pcm), piece):
        out = pred.predict_stream(pcm[i:i + piece],
                                  is_end=i + piece >= len(pcm))
    return out


def stream_text(pred, pcm, piece=PIECE):
    """Stream ``pcm`` through ``pred`` in pieces; the final text."""
    return stream_result(pred, pcm, piece)['text']


def batch_utts(pcms):
    """The batch phase's five utterances: the three, the first half of the
    first and the last two thirds of the third (mixed lengths, a batch that
    is not a power of two)."""
    return list(pcms) + [pcms[0][:len(pcms[0]) // 2],
                         pcms[2][len(pcms[2]) // 3:]]


def engine_texts(engine, pcms, piece=PIECE, stagger=2):
    """Feed int16 utterance i through its own stream of ``engine`` as PCM
    bytes, ``piece`` samples at a time, one piece per open stream in turn;
    stream i opens once stream i − 1 has fed ``stagger`` pieces. The final
    texts."""
    n = len(pcms)
    slots, pos, fed, texts = [], [0] * n, [0] * n, [None] * n
    while any(t is None for t in texts):
        if len(slots) < n and (not slots or fed[len(slots) - 1] >= stagger):
            slots.append(engine.open_stream())
        for i, slot in enumerate(slots):
            if texts[i] is not None:
                continue
            pos[i] += piece
            end = pos[i] >= len(pcms[i])
            out = engine.feed(slot, pcms[i][pos[i] - piece:pos[i]].tobytes(),
                              is_end=end)
            fed[i] += 1
            if end:
                texts[i] = out['text']
                engine.close_stream(slot)
    return texts


def host_features(pred, pcms):
    """[B, T_max, D] zero-padded host features of ``pcms`` from the
    predictor's offline featurizer, and their [B] frame counts."""
    feats = [pred.audio_featurizer.featurize(pred._load_audio(p))
             for p in pcms]
    x = np.zeros((len(feats), max(f.shape[0] for f in feats),
                  feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        x[i, :f.shape[0]] = f
    return x, np.array([f.shape[0] for f in feats], np.int32)


def rows_to_texts(collapse, ids, max_probs, out_lens, vocabulary):
    """Greedy texts of [B, T'] id and score planes cut at ``out_lens``."""
    return [collapse(ids[b, :int(n)], max_probs[b, :int(n)], vocabulary)[1]
            for b, n in enumerate(out_lens)]


def main():
    sys.path.insert(0, ROOT)
    from ppasr_tpu.decoders.greedy import _collapse
    from ppasr_tpu.models.streaming_eval import streaming_greedy_batch
    from ppasr_tpu.predict import PPASRPredictor
    from ppasr_tpu.serving import StreamingBatchEngine
    texts = sentences()
    pcms = render(texts)
    with tempfile.TemporaryDirectory() as tmp:
        artifact = flagship_artifact(tmp)
        pred = PPASRPredictor(model_path=artifact, use_device_frontend=True)
        host = PPASRPredictor(model_path=artifact)
        offline = [pred.predict(p)['text'] for p in pcms]
        stream = [stream_text(pred, p) for p in pcms]
        batch = [r['text'] for r in host.predict_batch(batch_utts(pcms))]
        batch_device = [r['text']
                        for r in pred.predict_batch(batch_utts(pcms))]
        engine = engine_texts(StreamingBatchEngine(pred, max_streams=4),
                              pcms)
        x, lens = host_features(pred, pcms)
        stream_eval = rows_to_texts(
            _collapse, *streaming_greedy_batch(pred.model, pred.params, x,
                                               lens), pred.vocab_list)
        beam = {}
        dev = PPASRPredictor(model_path=artifact, use_device_frontend=True,
                             decoder='ctc_beam_search',
                             decoder_configs=beam_conf())
        beam['jax_beam_offline'] = [dev.predict(p) for p in pcms]
        beam['jax_beam_stream'] = [stream_result(dev, p) for p in pcms]
        beam['jax_beam_batch_device'] = dev.predict_batch(batch_utts(pcms))
        nat = PPASRPredictor(model_path=artifact, decoder='ctc_beam_search',
                             decoder_configs=dict(beam_conf(),
                                                  backend='native'))
        beam['jax_beam_native'] = [nat.predict(p) for p in pcms]
    beam_keys = {}
    for key, results in beam.items():
        beam_keys[key] = np.array([r['text'] for r in results])
        beam_keys[key + '_scores'] = np.array([r['score'] for r in results],
                                              np.float32)
    np.savez_compressed(
        OUT, pcm=np.concatenate(pcms), lengths=np.array([len(p) for p in pcms]),
        texts=np.array(texts), jax_offline=np.array(offline),
        jax_stream=np.array(stream), seed=np.array(SEED),
        piece=np.array(PIECE), jax_batch=np.array(batch),
        jax_batch_device=np.array(batch_device), jax_engine=np.array(engine),
        jax_stream_eval=np.array(stream_eval), beam_lm=np.array(BEAM_LM),
        beam_conf=np.array(json.dumps(BEAM_CONF)), **beam_keys)
    print(OUT, os.path.getsize(OUT), 'bytes')
    for row in zip(texts, offline, stream, engine, stream_eval):
        print(*row)
    for b, d in zip(batch, batch_device):
        print(b, d)
    for key, texts in beam_keys.items():
        print(key, list(texts))


if __name__ == '__main__':
    main()
