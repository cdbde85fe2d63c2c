"""Streaming traffic through ``serving.StreamingBatchEngine``, the engine
behind the WebSocket server, at its defaults: the host frontend, greedy
partial results, ``max_streams`` equal to the speakers.

One thread feeds every piece in due order (the engine's lock serialises
feeds in the server too), opening a stream at an utterance's first piece
and closing it after its last. A piece's latency runs from its due time to
the return of its ``feed``; pieces still due when the window closes are fed
after it, for at most a minute, and count as failed if never fed.

The output check takes, once the window has closed, a seeded sample of the
utterances that finished (the longest among them). For each it compares
the posteriors the model's chunk step returned for the stream's slot
(captured at the call into the model) with the reference's, run over the
same windows from the same PCM, and the served text with the greedy
collapse of those posteriors."""
import math
import time

import numpy as np
import torch

from harness import check, traffic
from harness.model import build_predictor
from harness.window import Window
from harness.spec import flops_module, reference_module
from reference import fbank

def window_plan(n_samples: int, piece: int, chunk: int, cache: int):
    """The engine's windows over one utterance fed in pieces of ``piece``
    samples: [(piece index, first frame, frames, valid outputs, valid cache
    frames)], the last a flush of what is left (at least 7 frames)."""
    win, stride = (chunk - 1) * 4 + 7, chunk * 4
    plan, done = [], 0
    n_pieces = -(-n_samples // piece)
    for p in range(n_pieces):
        frames = fbank.n_frames(min((p + 1) * piece, n_samples))
        while frames - done * stride >= win:
            plan.append((p, done * stride, win, chunk,
                         min(done * chunk, cache)))
            done += 1
    left = frames - done * stride
    if left >= 7:
        plan.append((n_pieces - 1, done * stride, left, (left - 7) // 4 + 1,
                     min(done * chunk, cache)))
    return plan


class Capture:
    """The fed stream's posteriors from each chunk step, copied to the host
    (the engine reads them there next), so that the card's memory peak is
    the program's alone."""

    def __init__(self):
        self.uid = self.slot = None
        self.probs = {}

    def store(self, probs):
        if self.uid is not None:
            self.probs.setdefault(self.uid, []).append(
                probs[self.slot].to('cpu', copy=True))


def run(ctx):
    cell, seed, tracer = ctx.cell, ctx.seed, ctx.tracer
    conf, mix = cell.config, cell.traffic
    flops = flops_module(cell.entry['config'])
    from ppasr_tpu_torch.serving import StreamingBatchEngine
    pred, W, cmvn = build_predictor(
        conf, seed, ctx.device, decoding_chunk_size=mix['decoding_chunk_size'])
    engine = StreamingBatchEngine(pred, max_streams=int(mix['streams']))
    cap = Capture()

    featurize = pred.stream_featurizer.featurize
    step = pred.model.get_encoder_out_chunk

    def traced_featurize(seg):
        with tracer.span('featurize'):
            return featurize(seg)

    def traced_step(xs, state):
        with tracer.span('chunk_step'):
            probs, new_state = step(xs, state)
        cap.store(probs)
        return probs, new_state
    pred.stream_featurizer.featurize = traced_featurize
    pred.model.get_encoder_out_chunk = traced_step

    utts, pieces, piece = traffic.stream_schedule(mix, seed, ctx.seconds)
    used = sorted({uid for _, uid, _, _ in pieces})
    pcms = traffic.synth_audio([utts[u].n_samples for u in used],
                               [utts[u].level for u in used], seed,
                               pred.device)
    for u, pcm in zip(used, pcms):
        utts[u].pcm = pcm
    chunk, cache = pred.decoding_chunk_size, pred.cache_size
    plans = {u: window_plan(utts[u].n_samples, piece, chunk, cache)
             for u in used}

    # warm-up: the one tick shape, full windows and a flush, on spare audio
    warm = traffic.synth_audio([int(2.1 * traffic.RATE)] * 2, [-25.0] * 2,
                               seed + 1, pred.device)
    for pcm in warm:
        slot = engine.open_stream()
        for a in range(0, len(pcm), piece):
            engine.feed(slot, pcm[a:a + piece].tobytes(),
                        is_end=a + piece >= len(pcm))
        engine.close_stream(slot)
    check.sync(pred.device)

    n = len(pieces)
    latency = np.full(n, np.inf)
    late = np.zeros(n)
    finals, slots = {}, {}
    window_flops = {u: [flops.chunk_flops(conf, t, n_out, cached)
                        for _, _, t, n_out, cached in plans[u]]
                    for u in used}
    per_piece = {}
    for u in used:
        for w, (p, *_rest) in enumerate(plans[u]):
            per_piece.setdefault((u, p), []).append(w)
    totals = {'windows': 0, 'flops': 0, 'pieces': 0}
    grace = ctx.seconds + 60.0
    window = Window(ctx, mix['trace_seconds'], lambda: dict(
        totals, ticks=engine.ticks, tick_seconds=engine.tick_seconds))

    def advance(now):
        i = totals['pieces']
        if i >= n or now > grace:
            return False
        due, uid, idx, is_end = pieces[i]
        if due > now:
            with tracer.span('wait'):
                time.sleep(due - now)
        start = window.clock()
        u = utts[uid]
        a, b = u.piece_bounds(piece)[idx]
        with tracer.span('feed'):
            if idx == 0:
                slots[uid] = engine.open_stream()
            cap.uid, cap.slot = uid, slots[uid]
            res = engine.feed(slots[uid], u.pcm[a:b].tobytes(), is_end=is_end)
            cap.uid = None
            if is_end:
                engine.close_stream(slots.pop(uid))
                finals[uid] = res['text']
        latency[i], late[i] = window.clock() - due, start - due
        for w in per_piece.get((uid, idx), ()):
            totals['windows'] += 1
            totals['flops'] += window_flops[uid][w]
        totals['pieces'] += 1
        return True
    window.run(advance)

    head, tail = window.head, window.tail
    head['late_s'] = [late[j] for j in range(n)
                      if pieces[j][0] < head['seconds'] and
                      np.isfinite(latency[j])]
    head['latency_s'] = [latency[j] for j in range(n)
                         if pieces[j][0] < head['seconds']]
    failed = int(np.sum(~np.isfinite(latency)))
    p95 = float(np.percentile(latency, 95)) * 1e3
    e2e = {'stream_latency_p95_ms': p95 if math.isfinite(p95)
           else (grace - ctx.seconds) * 1e3}

    # ---------------------------------------------------------------- check
    probs = cap.probs
    del engine, pred, cap, step, featurize, traced_step, traced_featurize
    check.release()
    rng = np.random.default_rng(traffic.sub_seed(seed, 3))
    done = [u for u in used if u in finals]
    sample = []
    if done:
        longest = max(done, key=lambda u: utts[u].n_samples)
        rest = [u for u in done if u != longest]
        k = min(len(rest), int(mix['check_utterances']) - 1)
        sample = [longest] + [rest[j] for j in
                              rng.choice(len(rest), k, replace=False)]
    readings = check.Readings()
    ref_mod = reference_module(conf['family'])
    vocab = ['<blank>', '<unk>'] + [chr(0x4E00 + j) for j in
                                    range(conf['vocab_size'] - 3)] + ['<eos>']
    target_db = conf['preprocess_conf']['target_dB']
    for u in sample:
        plan = plans[u]
        got = probs.get(u, [])
        ref = reference_stream(ref_mod, W, cmvn, conf, cache, utts[u], plan,
                               piece, chunk, target_db, tf32=False)
        if ctx.control:
            got = reference_stream(ref_mod, W, cmvn, conf, cache, utts[u],
                                   plan, piece, chunk, target_db, tf32=True)
        if len(got) != len(plan):
            readings.served_mismatch += 1
            continue
        prog = torch.cat([g[:w[3]] for g, w in zip(got, plan)]).to(
            ref[0].device)
        readings.add_probs(prog, torch.cat(ref))
        if not ctx.control and check.collapse(
                prog.argmax(-1).tolist(), vocab) != finals[u]:
            readings.served_mismatch += 1
    if not sample:
        readings.served_mismatch += 1
    return dict(e2e=e2e, head=head, tail=tail, attempted=n, failed=failed,
                values=readings.values(), checked=readings.frames)


def plan_win(chunk: int) -> int:
    return (chunk - 1) * 4 + 7


def reference_stream(ref_mod, W, cmvn, conf, cache, utt, plan, piece, chunk,
                     target_db, tf32):
    """The reference's posteriors of each planned window, [n_out, V] each:
    log-mel of the whole utterance, the running-RMS gain of the samples fed
    up to the window's piece as an additive log-mel offset, the window
    zero-padded to its full length, one chunk step."""
    dev = W['ctc.ctc_lo.weight'].device
    samples = utt.pcm.astype(np.float64)
    feats = torch.from_numpy(fbank.logmel(samples)).to(dev)
    sq = np.cumsum((samples / 32768.0) ** 2)
    win = plan_win(chunk)
    out = []
    with check.precision(tf32):
        stream = ref_mod.Stream(W, cmvn, conf, cache, dev)
        for p, first, t, n_out, _ in plan:
            n = min((p + 1) * piece, utt.n_samples)
            rms_db = 10.0 * math.log10(sq[n - 1] / n + 1e-20)
            gain = min(target_db - rms_db, 300.0) * math.log(10.0) / 10.0
            x = torch.zeros(win, feats.shape[1], device=dev)
            x[:t] = feats[first:first + t] + gain
            out.append(stream.step(x)[:n_out])
    return out
