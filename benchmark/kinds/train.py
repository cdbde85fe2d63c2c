"""Training through ``train_state.make_train_step``, the step
``PPASRTrainer`` runs: the configuration's batch × accum_grad utterances an
update, the device frontend (kernel B1 with the dither, then SpecAugment
and SpecSub from the mix's ``augmentation``), the hybrid CTC and attention
loss, the global-norm clip and AdamW at WarmupLR's rate.

Set-up builds one train state from the seeded weights and drives it
through the first ``check_updates`` updates, through the window's own call
and feed; the window then runs the same state on, update after update over
the seeded pool, until ``--seconds`` have passed.

The output check runs the reference over those first updates, from the
same weights, batches and per-update seeds, and compares, each by the worst
leaf where it is per leaf:

- ``loss_gap``: each update's mean loss, relative to the reference's;
- ``grad_gap``: the first update's clipped gradient, as AdamW holds it
  after one step (its first moment over 1 − β1), leaf norm against the
  reference's, over the larger of that leaf's and the median leaf's norm;
- ``change_gap``: each leaf's change over the checked updates, its norm
  against the reference's, over the larger of that leaf's and the median
  leaf's change, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves those by round-off alone).
"""
import math

import numpy as np
import torch

from harness import check, traffic
from harness.spec import flops_module
from harness.window import Window
from harness.weights import make_cmvn, make_weights, sub_seed
from reference import fbank
from reference import train as ref_train

SAMPLE_BUCKET = 64 * 160


def pool_batches(conf, mix, seed, device):
    """[pool_updates] (wav [A, B, S], wav_lens, text [A, B, U], text_lens)
    on the device: each update's accum_grad × batch_size utterances draw
    one length from each of as many strata (so every seed pads alike), and
    are padded to the update's longest, in steps of 64 frames' samples, as
    the raw collate pads them; labels of ``tokens_per_s`` ids a second,
    uniform over the vocabulary less blank and eos."""
    accum, bsz = conf['train_conf']['accum_grad'], \
        conf['dataset_conf']['batch_size']
    per = accum * bsz
    n_up = int(mix['pool_updates'])
    lengths = traffic.quantiles(mix['length_s'], per * n_up).reshape(per,
                                                                     n_up)
    rng = np.random.default_rng(sub_seed(seed, 1))
    strata = np.stack([rng.permutation(row) for row in lengths])
    levels = rng.permutation(traffic.quantiles(mix['level_dbfs'],
                                               per * n_up))
    n_samples = [[int(round(strata[i, u] * traffic.RATE))
                  for i in rng.permutation(per)] for u in range(n_up)]
    flat = [n for up in n_samples for n in up]
    pcms = traffic.synth_audio(flat, levels, seed, device)
    tokens = [max(1, round(mix['tokens_per_s'] * n / traffic.RATE))
              for n in flat]
    out = []
    for u in range(n_up):
        rows = range(u * per, (u + 1) * per)
        s = -(-max(flat[i] for i in rows) // SAMPLE_BUCKET) * SAMPLE_BUCKET
        wav = np.zeros((per, s), np.float32)
        text = np.full((per, max(tokens[i] for i in rows)), -1, np.int64)
        for j, i in enumerate(rows):
            wav[j, :flat[i]] = pcms[i]
            text[j, :tokens[i]] = rng.integers(1, conf['vocab_size'] - 1,
                                               tokens[i])
        t = lambda a, dt: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=device).reshape(
                accum, bsz, *np.shape(a)[1:])
        out.append((t(wav, torch.float32),
                    t([flat[i] for i in rows], torch.long),
                    t(text, torch.long),
                    t([tokens[i] for i in rows], torch.long)))
    return out


def augmentation(mix):
    """The feature stages' settings as the program reads them from the
    augmentation list, for the reference."""
    spec = next(a for a in mix['augmentation'] if a['type'] == 'specaug')
    sub = next(a for a in mix['augmentation'] if a['type'] == 'specsub')
    out = {k: v for k, v in spec['params'].items() if k != 'inplace'}
    out.update(spec_sub_max_t=sub['params']['max_t'],
               spec_sub_num=sub['params']['num_t_sub'],
               prob=max(spec['prob'], sub['prob']))
    return out


def leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |‖got‖ − ‖ref‖| over the larger of ‖ref‖ and the
    median leaf's ‖ref‖."""
    names = [k for k in ref if keep is None or keep[k]]
    ref_n = {k: float(ref[k].double().norm()) for k in names}
    med = float(np.median(list(ref_n.values())))
    return max(abs(float(got[k].double().norm()) - ref_n[k])
               / max(ref_n[k], med) for k in names)


def run(ctx):
    cell, seed, tracer = ctx.cell, ctx.seed, ctx.tracer
    conf, mix = cell.config, cell.traffic
    dev = ctx.device
    flops, b1 = flops_module(cell.entry['config']), flops_module('b1')
    from ppasr_tpu_torch.models.base import GlobalCMVN
    from ppasr_tpu_torch.models.factory import build_model
    from ppasr_tpu_torch.ops.frontend import make_device_frontend
    import ppasr_tpu_torch.models.ctc as ctc_mod
    import ppasr_tpu_torch.ops.frontend as frontend_mod
    from ppasr_tpu_torch.train_state import (create_train_state,
                                             make_train_step)

    W = make_weights(ref_train.param_shapes(conf), seed, dev)
    cmvn = make_cmvn(conf['input_dim'], seed, dev)
    model = build_model(conf['use_model'], conf['input_dim'],
                        conf['vocab_size'], conf['streaming'],
                        conf['encoder_conf'], conf['decoder_conf'],
                        conf['model_conf']).to(dev)
    with torch.no_grad():
        model.load_state_dict(W, strict=True)
    model.encoder.global_cmvn = GlobalCMVN(
        *(c.cpu().numpy() for c in cmvn)).to(dev)
    state = create_train_state(model, conf['optimizer_conf'],
                               conf['train_conf']['grad_clip'])
    frontend = make_device_frontend(conf['preprocess_conf'],
                                    mix['augmentation'])
    accum = conf['train_conf']['accum_grad']
    step = make_train_step(accum, frontend)
    batches = pool_batches(conf, mix, seed, dev)
    seeds = [sub_seed(seed, 10 + u) for u in range(len(batches))]
    names = [n for n, _ in model.named_parameters()]

    b1_bounds = []
    ctc_loss = ctc_mod.ctc_loss_from_logits
    fbank_batch = frontend_mod.fbank_batch

    def traced_ctc(*args, **kw):
        with tracer.span('ctc'):
            return ctc_loss(*args, **kw)

    def traced_fbank(wavs, lens, **kw):
        with tracer.span('fbank'):
            out = fbank_batch(wavs, lens, **kw)
        if tracer.active and ctx.peaks is not None:
            b, s = wavs.shape
            noise = kw.get('noise')
            b1_bounds.append(b1.bound_s(
                b * (s // 160) - 2, b * s, ctx.peaks,
                noise_floats=0 if noise is None else noise.numel())[0])
        return out
    ctc_mod.ctc_loss_from_logits = traced_ctc
    frontend_mod.fbank_batch = traced_fbank

    def update(u):
        wav, wav_lens, text, tlens = batches[u % len(batches)]
        with tracer.span('update'):
            out = step(state, {'wav': wav, 'wav_lens': wav_lens,
                               'text': text, 'text_lens': tlens},
                       seeds[u % len(seeds)])
        return out

    n_check = int(mix['check_updates'])
    losses, first, after = [], None, None
    for u in range(n_check):
        losses.append(float(update(u)['loss']))
        if u == 0:
            first = {n: state.optimizer.state[p]['exp_avg'] / 0.1
                     if 'exp_avg' in state.optimizer.state[p]
                     else torch.zeros_like(p)
                     for n, p in zip(names, state.params)}
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    check.sync(dev)
    audio = [float(b[1].sum()) / traffic.RATE for b in batches]
    per_update = [sum(flops.utterance_train_flops(
        conf, fbank.n_frames(int(n)), int(t))
        for n, t in zip(b[1].flatten().tolist(), b[3].flatten().tolist()))
        for b in batches]

    totals = {'updates': 0, 'audio_s': 0.0, 'flops': 0}
    last = {}

    def advance(now):
        if now >= ctx.seconds:
            return False
        u = n_check + totals['updates']
        last['metrics'] = update(u)
        totals['updates'] += 1
        totals['audio_s'] += audio[u % len(batches)]
        totals['flops'] += per_update[u % len(batches)]
        return True
    window = Window(ctx, mix['trace_seconds'], lambda: dict(totals))
    window.run(advance)
    final_loss = float(last['metrics']['loss']) if last else math.nan
    ctc_mod.ctc_loss_from_logits = ctc_loss
    frontend_mod.fbank_batch = fbank_batch

    head, tail = window.head, window.tail
    tail['b1_bound_s'] = b1_bounds
    e2e = {'train_audio_s_per_s': totals['audio_s'] / window.seconds}

    # ---------------------------------------------------------------- check
    del state, model, step, frontend
    check.release()
    aug = augmentation(mix)
    with check.precision(False):
        ref_losses, ref_first, ref_after = ref_train.updates(
            W, cmvn, conf, aug, batches[:n_check], seeds[:n_check])
    if ctx.control:
        with check.precision(True):
            losses, first, after = ref_train.updates(
                W, cmvn, conf, aug, batches[:n_check], seeds[:n_check])
    med = float(np.median([float(g.double().norm())
                           for g in ref_first.values()]))
    moved = {k: float(g.double().norm()) >= 1e-3 * med
             for k, g in ref_first.items()}
    values = {
        'loss_gap': max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                            ref_losses)),
        'grad_gap': leaf_gap(first, ref_first),
        'change_gap': leaf_gap({k: after[k] - W[k] for k in W},
                               {k: ref_after[k] - W[k] for k in W}, moved),
    }
    if not math.isfinite(final_loss):
        values['loss_gap'] = math.inf
    return dict(e2e=e2e, head=head, tail=tail,
                attempted=totals['updates'] + n_check, failed=0,
                values=values, checked=n_check)

