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
# bfloat16: the largest |Δ| allowed between the port's and the JAX
# package's CTC log-probs (the flagship on the CPU differs by up to 0.66,
# each package's bf16 from float32 by up to 0.46: tests/test_torch_bf16.py)
BF16_LOGPROB_TOL = 1.0
# the near-tie rule of the bfloat16 paths: where a greedy text differs from
# JAX's, every frame whose argmax differs must have a JAX top-2 log-prob
# (so logit) margin below this: two log-probs that each move by
# BF16_LOGPROB_TOL can swap
BF16_LOGIT_TOL = 2 * BF16_LOGPROB_TOL
# the long recording of predict_long: quiet noise between the utterances
LONG_SEED = 20241017
LONG_GAP = 8000       # 0.5 s


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
    return [r['text'] for r in engine_results(engine, pcms, piece, stagger)]


def engine_results(engine, pcms, piece=PIECE, stagger=2):
    """``engine_texts``' feeding; the final {'text', 'score'} of each
    stream."""
    n = len(pcms)
    slots, pos, fed, out = [], [0] * n, [0] * n, [None] * n
    while any(r is None for r in out):
        if len(slots) < n and (not slots or fed[len(slots) - 1] >= stagger):
            slots.append(engine.open_stream())
        for i, slot in enumerate(slots):
            if out[i] is not None:
                continue
            pos[i] += piece
            end = pos[i] >= len(pcms[i])
            res = engine.feed(slot, pcms[i][pos[i] - piece:pos[i]].tobytes(),
                              is_end=end)
            fed[i] += 1
            if end:
                out[i] = res
                engine.close_stream(slot)
    return out


def long_recording(pcms, seed=LONG_SEED, gap=LONG_GAP):
    """int16 PCM of ``pcms`` with ``gap`` samples of quiet noise (std 30)
    before each and after the last, from ``seed``."""
    rng = np.random.default_rng(seed)
    parts = []
    for p in pcms:
        parts += [(rng.standard_normal(gap) * 30).astype('<i2'), p]
    parts.append((rng.standard_normal(gap) * 30).astype('<i2'))
    return np.concatenate(parts)


class PosteriorRecorder:
    """Within ``with``, records the CTC posteriors that greedy decoding
    reads: each ``greedy_decoder`` call, each row of a
    ``greedy_decoder_batch`` call (cut at its length), and each streaming
    decoder's chunks joined, in the order the decoders first decode. Give
    it the package's ``predict`` and ``decoders.greedy`` modules; as
    ``utts``, each utterance's (argmax ids, top-2 log-prob margins)."""

    def __init__(self, predict_module, greedy_module):
        self.mods = (predict_module, greedy_module)
        self.utts, self._streams = [], {}

    def _add(self, probs):
        p = np.asarray(probs.detach().float().cpu() if hasattr(
            probs, 'detach') else probs, np.float32)
        top2 = np.sort(p, axis=-1)[:, -2:]
        margin = np.log(np.maximum(top2[:, 1], 1e-30)) \
            - np.log(np.maximum(top2[:, 0], 1e-30))
        return [p.argmax(-1).astype(np.int32), margin.astype(np.float32)]

    def __enter__(self):
        predict_module, greedy = self.mods
        saved = self._saved = []

        def patch(obj, name, fn):
            saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)
        single, batch = greedy.greedy_decoder, greedy.greedy_decoder_batch
        chunk = greedy.GreedyStreamingDecoder.decode_chunk

        def rec_single(probs, *a, **k):
            self.utts.append(self._add(probs))
            return single(probs, *a, **k)

        def rec_batch(probs, lens, *a, **k):
            for b, n in enumerate(lens):
                self.utts.append(self._add(probs[b][:int(n)]))
            return batch(probs, lens, *a, **k)

        def rec_chunk(dec, probs, *a, **k):
            if len(probs):
                if id(dec) not in self._streams:
                    self._streams[id(dec)] = (dec, len(self.utts))
                    self.utts.append([np.zeros(0, np.int32),
                                      np.zeros(0, np.float32)])
                i = self._streams[id(dec)][1]
                self.utts[i] = [np.concatenate([x, y]) for x, y in
                                zip(self.utts[i], self._add(probs))]
            return chunk(dec, probs, *a, **k)
        for mod in (predict_module, greedy):
            if hasattr(mod, 'greedy_decoder'):
                patch(mod, 'greedy_decoder', rec_single)
            if hasattr(mod, 'greedy_decoder_batch'):
                patch(mod, 'greedy_decoder_batch', rec_batch)
        patch(greedy.GreedyStreamingDecoder, 'decode_chunk', rec_chunk)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)

    def pack(self, n=None):
        """The first ``n`` utterances as (ids, margins, frame counts)."""
        utts = self.utts[:n]
        return (np.concatenate([u[0] for u in utts]),
                np.concatenate([u[1] for u in utts]),
                np.array([len(u[0]) for u in utts], np.int32))


def near_tie_failures(got_texts, want_texts, got_ids, want_ids,
                      want_margins, frames, tol=BF16_LOGIT_TOL):
    """The bfloat16 rule: texts equal, or, for each utterance whose text
    differs, the same frame count and a JAX top-2 margin below ``tol`` at
    every frame whose argmax differs. → list of the failures (empty when
    the rule holds); ``got_ids`` and the rest are packed as
    ``PosteriorRecorder.pack`` packs them."""
    bad, start = [], 0
    want_ids = np.asarray(want_ids)
    for i, n in enumerate(np.asarray(frames)):
        n = int(n)
        if got_texts[i] != want_texts[i]:
            g = np.asarray(got_ids[i])
            w, m = want_ids[start:start + n], np.asarray(
                want_margins)[start:start + n]
            if g.shape != w.shape:
                bad.append((i, f'{len(g)} frames, JAX {n}'))
            else:
                off = np.nonzero(g != w)[0]
                if not len(off) or (m[off] >= tol).any():
                    bad.append((i, f'frames {off.tolist()} margins '
                                   f'{m[off].tolist()}'))
        start += n
    return bad


def texts_under_near_ties(run_want, want_modules, run_got, got_modules,
                          tol=BF16_LOGIT_TOL):
    """Run ``run_want`` (the reference) and ``run_got``, each returning
    greedy texts, under ``PosteriorRecorder(*modules)``; → (the texts
    ``run_got`` gave, ``near_tie_failures`` against the reference)."""
    with PosteriorRecorder(*want_modules) as want_rec:
        want = run_want()
    with PosteriorRecorder(*got_modules) as got_rec:
        got = run_got()
    ids, margins, frames = want_rec.pack(len(want))
    return got, near_tie_failures(got, want, [u[0] for u in got_rec.utts],
                                  ids, margins, frames, tol)


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
        del dev, nat
        res = PPASRPredictor(model_path=artifact, use_device_frontend=True,
                             decoder='attention_rescoring',
                             decoder_configs=beam_conf())
        beam['jax_rescore_offline'] = [res.predict(p) for p in pcms]
        beam['jax_rescore_batch_device'] = res.predict_batch(
            batch_utts(pcms))
        beam['jax_rescore_stream'] = [stream_result(res, p) for p in pcms]
        beam['jax_rescore_engine'] = engine_results(
            StreamingBatchEngine(res, max_streams=4), pcms)
        del res
        extra = bf16_keys(artifact, pcms)
        extra.update(long_keys(pred, pcms))
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
        beam_conf=np.array(json.dumps(BEAM_CONF)), **beam_keys, **extra)
    print(OUT, os.path.getsize(OUT), 'bytes')
    for row in zip(texts, offline, stream, engine, stream_eval):
        print(*row)
    for b, d in zip(batch, batch_device):
        print(b, d)
    for key, texts in list(beam_keys.items()) + list(extra.items()):
        print(key, list(texts) if texts.ndim else texts)


def bf16_keys(artifact, pcms):
    """The JAX bfloat16 flagship's greedy texts through ``predict``,
    ``predict_batch`` (device frontend), ``predict_stream`` (device
    frontend) and the engine, each with the per-frame argmax ids, top-2
    log-prob margins and frame counts that the near-tie rule reads."""
    import ppasr_tpu.decoders.greedy as greedy
    import ppasr_tpu.predict as predict
    from ppasr_tpu.serving import StreamingBatchEngine
    pred = predict.PPASRPredictor(model_path=artifact,
                                  use_device_frontend=True,
                                  compute_dtype='bfloat16')
    runs = {
        'offline': lambda: [pred.predict(p)['text'] for p in pcms],
        'batch_device': lambda: [r['text'] for r in pred.predict_batch(
            batch_utts(pcms))],
        'stream': lambda: [stream_text(pred, p) for p in pcms],
        'engine': lambda: engine_texts(StreamingBatchEngine(
            pred, max_streams=4), pcms),
    }
    out = {}
    for name, run in runs.items():
        with PosteriorRecorder(predict, greedy) as rec:
            texts = run()
        ids, margins, frames = rec.pack(len(texts))
        key = f'jax_bf16_{name}'
        out.update({key: np.array(texts), key + '_ids': ids.astype(np.int16),
                    key + '_margins': margins, key + '_frames': frames})
    return out


def long_keys(pred, pcms):
    """``predict_long`` on ``long_recording(pcms)``: the VAD's speech
    timestamps ([n, 2] start and end samples) and the results without and
    with punctuation and ITN."""
    from ppasr_tpu.infer_utils.vad_predictor import VADPredictor
    wav = long_recording(pcms)
    stamps = VADPredictor().get_speech_timestamps(
        wav.astype(np.float32) / 32768.0)
    plain = pred.predict_long(wav)
    marked = pred.predict_long(wav, use_pun=True, is_itn=True)
    return {'jax_long_vad': np.array([[s['start'], s['end']]
                                      for s in stamps], np.int64),
            'jax_long': np.array(plain['text']),
            'jax_long_score': np.array(plain['score'], np.float32),
            'jax_long_pun_itn': np.array(marked['text']),
            'jax_long_pun_itn_score': np.array(marked['score'], np.float32)}


if __name__ == '__main__':
    main()
