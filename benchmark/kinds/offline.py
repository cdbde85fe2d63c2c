"""Offline transcription through ``PPASRPredictor.predict_batch`` in a
closed loop: batch after batch of the seeded pool, each call's results
back before the next is sent.

The output check compares, for a seeded sample of the pool's first pass
(always the batch with the longest utterance), the posteriors and output
lengths the model returned for every row (captured at the call into the
model) with the reference's over the same padded batch, worked out from
the same PCM: the dB normalisation and int16 rounding of the waveform, the
fbank of every frame of the padded row, CMVN, encoder and CTC head; and
each served text with the greedy collapse of the captured posteriors."""
import math

import numpy as np
import torch

from harness import check, traffic
from harness.model import build_predictor
from harness.window import Window
from harness.spec import flops_module, reference_module
from reference import fbank

REF_ROWS = 16     # rows of a batch the reference runs at once


def waveform(pcm: np.ndarray, target_db: float) -> np.ndarray:
    """int16 PCM → the int16-scaled waveform the frontend reads: gain to
    ``target_db`` dBFS RMS, then int16 rounding toward zero with clipping."""
    x = pcm.astype(np.float64) / 32768.0
    gain = target_db - 10.0 * math.log10(float(np.mean(x * x)))
    x = np.clip(x * 10.0 ** (gain / 20.0) * 32768.0, -32768, 32767)
    return np.trunc(x)


def run(ctx):
    cell, seed, tracer = ctx.cell, ctx.seed, ctx.tracer
    conf, mix = cell.config, cell.traffic
    flops, b1 = flops_module(cell.entry['config']), flops_module('b1')
    import ppasr_tpu_torch.predict as predict_mod
    pred, W, cmvn = build_predictor(
        conf, seed, ctx.device,
        use_device_frontend=bool(mix['use_device_frontend']),
        time_bucket_frames=int(mix['time_bucket_frames']))

    pool = traffic.offline_pool(mix, seed)
    flat = [u for batch in pool for u in batch]
    pcms = traffic.synth_audio([n for n, _ in flat], [lv for _, lv in flat],
                               seed, pred.device)
    bsz = int(mix['batch'])
    batches = [pcms[b * bsz:(b + 1) * bsz] for b in range(len(pool))]
    audio_s = [sum(len(p) for p in b) / traffic.RATE for b in batches]

    rng = np.random.default_rng(traffic.sub_seed(seed, 3))
    longest = int(np.argmax([max(len(p) for p in b) for b in batches]))
    others = [b for b in range(len(batches)) if b != longest]
    k = min(len(others), int(mix['check_batches']) - 1)
    sampled = {longest, *(others[j] for j in rng.choice(len(others), k,
                                                         replace=False))}

    state = {'batch': None, 'captured': {}, 'fed': 0, 'padded': 0,
             'flops': 0, 'b1_bound_s': []}
    fbank_batch = predict_mod.fbank_batch
    encode = pred.model.get_encoder_out
    peaks = ctx.peaks

    def traced_fbank(wavs, lens, **kw):
        with tracer.span('fbank'):
            out = fbank_batch(wavs, lens, **kw)
        if tracer.active and peaks is not None:
            b, s = wavs.shape
            state['b1_bound_s'].append(
                b1.bound_s(b * (s // 160) - 2, b * s, peaks)[0])
        return out

    def traced_encode(xs, lens):
        with tracer.span('encoder'):
            probs, olens = encode(xs, lens)
        state['fed'] += xs.shape[0] * xs.shape[1]
        state['padded'] += xs.shape[0] * xs.shape[1] - int(lens.sum())
        if state['batch'] in sampled and state['batch'] not in \
                state['captured']:
            state['captured'][state['batch']] = (
                probs.to('cpu', copy=True), olens.to('cpu', copy=True))
        return probs, olens
    predict_mod.fbank_batch = traced_fbank
    pred.model.get_encoder_out = traced_encode

    batch_flops = [sum(flops.utterance_flops(conf, fbank.n_frames(len(p)))
                       for p in b) for b in batches]
    # warm-up: every padded shape of the pool once
    for b in batches:
        pred.predict_batch(b)
    check.sync(pred.device)
    state.update(fed=0, padded=0)

    totals = {'batches': 0, 'audio_s': 0.0, 'flops': 0}
    texts = {}
    attempted = failed = 0

    def advance(now):
        nonlocal attempted, failed
        if now >= ctx.seconds:
            return False
        i = totals['batches']
        b = i % len(batches)
        state['batch'] = b if i < len(batches) else None
        attempted += bsz
        with tracer.span('predict_batch'):
            try:
                res = pred.predict_batch(batches[b])
            except RuntimeError as err:
                print(f"predict_batch failed: {err}", flush=True)
                res = []
        failed += bsz - len(res)
        if i < len(batches):
            texts[b] = [r['text'] for r in res]
        totals['batches'] += 1
        totals['audio_s'] += audio_s[b] * len(res) / bsz
        totals['flops'] += batch_flops[b] if len(res) == bsz else 0
        return True
    window = Window(ctx, mix['trace_seconds'], lambda: dict(
        totals, frames_fed=state['fed'], frames_padded=state['padded']))
    window.run(advance)
    head, tail = window.head, window.tail
    tail['b1_bound_s'] = state['b1_bound_s']
    e2e = {'offline_audio_s_per_s': totals['audio_s'] / window.seconds}

    # ---------------------------------------------------------------- check
    captured = state['captured']
    vocab = pred.vocab_list
    predict_mod.fbank_batch = fbank_batch
    del pred, encode, traced_encode, state
    check.release()
    readings = check.Readings()
    ref_mod = reference_module(conf['family'])
    target_db = conf['preprocess_conf']['target_dB']
    for b in sorted(sampled):
        if b not in captured or len(texts.get(b, ())) != bsz:
            readings.served_mismatch += bsz
            continue
        probs, olens = (t.to(ctx.device) for t in captured[b])
        feats, lens = reference_features(batches[b], target_db,
                                         int(mix['time_bucket_frames']),
                                         conf['input_dim'], probs.device)
        for r0 in range(0, bsz, REF_ROWS):
            rows = slice(r0, r0 + REF_ROWS)
            with check.precision(False):
                ref, ref_lens = ref_mod.forward(W, cmvn, conf, feats[rows],
                                                lens[rows])
            if ctx.control:
                with check.precision(True):
                    got, got_lens = ref_mod.forward(W, cmvn, conf,
                                                    feats[rows], lens[rows])
            else:
                got, got_lens = probs[rows], olens[rows]
            for j in range(ref.shape[0]):
                n = int(ref_lens[j])
                if int(got_lens[j]) != n:
                    readings.served_mismatch += 1
                    continue
                readings.add_probs(got[j, :n], ref[j, :n])
                if not ctx.control and check.collapse(
                        got[j, :n].argmax(-1).tolist(),
                        vocab) != texts[b][r0 + j]:
                    readings.served_mismatch += 1
    return dict(e2e=e2e, head=head, tail=tail, attempted=attempted,
                failed=failed, values=readings.values(),
                checked=readings.frames)


def reference_features(pcms, target_db, bucket_frames, n_mels, device):
    """The padded batch's log-mel, every frame of each padded row, and the
    rows' valid frame counts (the reference's own frontend)."""
    wavs = [waveform(p, target_db) for p in pcms]
    step = bucket_frames * fbank.SHIFT
    s = -(-max(max(len(w) for w in wavs), fbank.WINDOW) // step) * step
    t = s // fbank.SHIFT - 2
    feats = np.zeros((len(wavs), t, n_mels), np.float32)
    lens = np.zeros(len(wavs), np.int64)
    for i, w in enumerate(wavs):
        row = np.zeros(s)
        row[:len(w)] = w
        feats[i] = fbank.logmel(row, t, n_mels)
        lens[i] = min(fbank.n_frames(len(w)), t)
    return (torch.from_numpy(feats).to(device),
            torch.from_numpy(lens).to(device))
