#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``ppasr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printed with its seconds; any failure raises and the exit code
is not 0:

1. card: CUDA present, ``nvidia-smi`` name and power limit, TF32 off for
   matmuls and cuDNN during the kernel check;
2. build: kernel B1 (``ppasr_tpu_torch/csrc/fbank.cu``) with nvcc for
   sm_90a, with ptxas' register and spill report;
3. kernel: B1 (a packed 256-point FFT, one warp per frame, and a banded
   mel projection) against its plain PyTorch version on the card and the
   host ``fbank_numpy`` at the main path's shape (one 67-frame streaming
   window, stride 160), at an odd frame count (997 frames, stride 160, also
   from a base pointer at an odd offset), at a 16 × 10 s batch (15,968
   frames, stride 400) and at the batch path's launch (``fbank_batch`` over
   16 rows of 80,000 samples: 7,998 frames at stride 160 over the flat
   buffer);
4. main path: the committed flagship streaming Conformer (256-dim, 12
   blocks) through ``PPASRPredictor(use_gpu=True, use_device_frontend=True)``
   on the three utterances of tests/fixtures/torch_smoke_utts.npz, offline
   and streamed in 0.16 s pieces, under PyTorch's default TF32 flags (the
   predictor turns TF32 off for its own calls); transcripts must equal the
   JAX package's recorded in the fixture, and the fbank kernel must have
   been launched once per streamed window;
5. batch: ``predict_batch`` over five utterances (the three and two cuts of
   them) on the device frontend and on the host frontend; transcripts must
   equal the fixture's JAX ``predict_batch`` texts, with exactly one fbank
   launch for the device-frontend batch; then ``fbank_batch`` against
   ``fbank_batch_torch`` on that batch on the card;
6. engine: ``StreamingBatchEngine(max_streams=4)`` over the three
   utterances fed as PCM bytes in 0.16 s pieces, interleaved and staggered;
   transcripts must equal the fixture's JAX engine texts;
7. stream eval: ``streaming_greedy_batch`` over the three utterances' host
   features; transcripts must equal the fixture's JAX texts; its CER
   (``utils/metrics.cer``) against the references;
8. beam: the flagship's beam search at its configured width (beam 300,
   ``cutoff_top_n`` 40, ``cutoff_prob`` 0.99, α 0.8, β 1.0, the trigram
   ``lm/synth_lm.arpa`` fused through the hash tables; the configuration
   read from the fixture) with the on-device backend on ``cuda:0``:
   ``predict`` on the three utterances, ``predict_stream`` on them in
   0.16 s pieces with the device frontend (one fbank launch per window)
   and ``predict_batch`` over the five on the device frontend (the logits
   path, one fbank launch); texts must equal the fixture's JAX beam texts
   and scores must agree within ``BEAM_SCORE_TOL``; the decoder's LM tables
   and streaming state must be on the card; then ``backend='native'``
   (csrc/ctc_decoder.cpp built with g++) on the three utterances against
   the fixture's JAX native texts. Prints each entry point's wall time per
   call, the frames the scan decoded after compaction, and one
   ``torch.profiler`` session (CUDA activity only) over one batch decode:
   device time and launches per scan step;
9. rescore: ``decoder='attention_rescoring'`` at the beam conf of phase 8
   (300 hypotheses of up to 200 tokens through the 3 + 3-block attention
   decoder, ``reverse_weight`` 0.3) on ``cuda:0`` with the device
   frontend: ``predict`` on the three utterances, ``predict_batch`` on the
   five, ``predict_stream`` in 0.16 s pieces and the engine over the three
   staggered streams; texts must equal the fixture's JAX rescoring texts
   and scores agree within ``BEAM_SCORE_TOL``; wall time per call, and one
   ``torch.profiler`` session (CUDA activity only) over one rescoring pass
   and one over the decoder's scores alone: device time and launches;
10. bf16: ``compute_dtype='bfloat16'`` with greedy decoding on the device
   frontend through ``predict``, ``predict_batch``, ``predict_stream`` and
   the engine; texts must equal the fixture's JAX bf16 texts or differ
   only at near ties (``fx.near_tie_failures``: every frame whose argmax
   differs has a JAX top-2 margin below ``fx.BF16_LOGIT_TOL``); the
   largest |Δ| of its CTC log-probs against the float32 predictor's, and
   each entry point's wall per call beside the float32 path's;
11. long: ``predict_long`` (Silero VAD on the card, segments through
   ``predict_batch``) on the three utterances with 0.5 s of quiet noise
   between them (``fx.long_recording``), without and with punctuation and
   ITN; the VAD's timestamps and both texts must equal the fixture's JAX
   ones, the Silero LSTM and the punctuation model must be on the card;
12. timing, after the paths, whose real-time factors are thus read
   before the process first runs the profiler: at each shape of phase 3,
   three rounds time in turn the kernel, the plain version,
   ``torch.fft.rfft`` alone on the same frames, and the kernel again, each
   per call (``call_ms``, CUDA events around back-to-back calls, host work
   included) and the kernel and ``rfft`` also on the device alone
   (``device_ms``, from ``torch.profiler`` recording CUDA activity only);
   and the bound. The kernel table's ``ms`` is ``call_ms`` at the window,
   its ``launches`` the launches of phases 4, 5 and 8–11 (one per streamed
   window, one per batch), and its ``max_abs_err`` the largest of phases 3
   and 5.

The line before the last is the card's ``nvidia-smi`` name and power limit,
the one before it the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Everything written goes under
``build/`` (listed in .gitignore).
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import ppasr_tpu_torch.decoders.greedy as greedy_module
import ppasr_tpu_torch.predict as predict_module
from ppasr_tpu_torch.decoders.beam_search_torch import all_hypotheses
from ppasr_tpu_torch.decoders.greedy import _collapse
from ppasr_tpu_torch.models.streaming_eval import streaming_greedy_batch
from ppasr_tpu_torch.ops import fbank as F
from ppasr_tpu_torch.ops import fbank_cuda
from ppasr_tpu_torch.predict import PPASRPredictor, ieee_float32
from ppasr_tpu_torch.serving import StreamingBatchEngine
from ppasr_tpu_torch.utils.metrics import cer, edit_distance

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, 'tests'))
import make_torch_smoke_fixture as fx  # noqa: E402  (no JAX at import)

BUILD = os.path.join(ROOT, 'build')

# H100 SXM data sheet peaks
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
MEAN_TOL, MAX_TOL = 1e-3, 0.05   # log-mel, tests/test_fbank_pallas.py:28-29
RFFT_LAUNCHES = 3   # kernels that one torch.fft.rfft(frames, n=512) launches


def phase(name, t0):
    print(f"[{name}] {time.time() - t0:.2f} s", flush=True)


def smi_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters, warmup=3):
    """Milliseconds per call of ``fn()``: CUDA events around ``iters``
    back-to-back calls, so the host work of each call is included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, launches_per_call, match=None, tries=3):
    """(device milliseconds per call of ``fn()``, launches recorded).
    ``torch.profiler``, recording CUDA activity only, over ``iters`` calls:
    the device time that ``key_averages()`` gives for the kernels whose name
    contains ``match`` (every kernel and copy when ``match`` is None), over
    the launches it recorded, times ``launches_per_call``. A session that
    records fewer than half the ``iters * launches_per_call`` launches, or
    more than them, is printed and run again, up to ``tries`` sessions; then
    this raises. It raises too if the profiler records no device time."""
    want = iters * launches_per_call
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, seen = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if match is not None and match not in evt.key:
                continue
            total_us += evt.self_device_time_total
            seen += evt.count
        if total_us <= 0:
            raise RuntimeError("torch.profiler recorded no device time")
        if want / 2 <= seen <= want:
            return total_us / seen * launches_per_call / 1e3, seen
        print(f"  profiler session recorded {seen} of {want} launches; "
              f"run again", flush=True)
    raise RuntimeError(f"torch.profiler recorded {seen} of {want} launches "
                       f"in each of {tries} sessions")


def bound_ms(n_frames, input_samples, num_mel_bins=80):
    """Least time for fbank on this card class: the larger of the bytes the
    function must move (samples, window, each filter's band of weights and
    its int32 band entry in, log-mel out) over the memory rate, and the fp32
    operations of an FFT-based fbank over the fp32 peak. A real n-point FFT
    counts 2.5·n·log2(n) operations."""
    mel = F.get_mel_banks(num_mel_bins, 512, 16000.0)
    band, weights = fbank_cuda.mel_bands(mel[:, :fbank_cuda.N_BINS])
    nnz = weights.size
    flops_per_frame = (4 * 400              # DC mean, pre-emphasis, window
                       + 2.5 * 512 * 9      # real 512-point FFT
                       + 3 * 257            # power
                       + 2 * nnz            # mel projection
                       + 2 * num_mel_bins)  # floor and log
    nbytes = (4 * (input_samples + 400 + nnz + n_frames * num_mel_bins)
              + band.nbytes)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = n_frames * flops_per_frame / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def compare(name, got, plain, host):
    """max/mean |Δ| of the kernel against the plain version and the host
    fbank_numpy; raises outside the bounds."""
    d_plain = (got - plain).abs()
    d_host = (got.cpu() - torch.from_numpy(host)).abs()
    row = {'max_abs_err': d_plain.max().item(),
           'mean_abs_err': d_plain.mean().item(),
           'max_abs_err_numpy': d_host.max().item(),
           'mean_abs_err_numpy': d_host.mean().item()}
    print(f"  {name}: vs plain max {row['max_abs_err']:.3g} mean "
          f"{row['mean_abs_err']:.3g}; vs fbank_numpy max "
          f"{row['max_abs_err_numpy']:.3g} mean "
          f"{row['mean_abs_err_numpy']:.3g}", flush=True)
    if not (torch.isfinite(got).all() and row['max_abs_err'] < MAX_TOL
            and row['mean_abs_err'] < MEAN_TOL
            and row['max_abs_err_numpy'] < MAX_TOL
            and row['mean_abs_err_numpy'] < MEAN_TOL):
        raise AssertionError(f"fbank kernel disagrees at {name}: {row}")
    return row


def time_shape(name, kernel_fn, plain_fn, frames, iters, reps=3):
    """Three rounds, each timing in turn the kernel, the plain version,
    ``torch.fft.rfft`` alone on the same frames, and the kernel again: the
    time per call (CUDA events) of each, and the device time of the kernel
    (one launch a call) and of ``rfft`` (``RFFT_LAUNCHES`` a call) with the
    launches the profiler recorded of ``iters`` calls. Returns every reading
    and their medians."""
    rfft_fn = lambda: torch.fft.rfft(frames, n=512)  # noqa: E731
    turns = []
    for rep in range(reps):
        row = {}
        for label, fn, per_call, match in (
                ('kernel', kernel_fn, 1, 'fbank_kernel'),
                ('plain', plain_fn, None, None),
                ('rfft', rfft_fn, RFFT_LAUNCHES, None),
                ('kernel_again', kernel_fn, 1, 'fbank_kernel')):
            row[f'{label}_call_ms'] = call_ms(fn, iters)
            if per_call:
                (row[f'{label}_device_ms'],
                 row[f'{label}_launches_profiled']) = device_ms(
                     fn, iters, per_call, match)
        print(f"  {name} round {rep + 1}: " + ", ".join(
            f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
        turns.append(row)

    def med(*keys):
        return statistics.median(t[k] for t in turns for k in keys)
    return {'device_ms': med('kernel_device_ms', 'kernel_again_device_ms'),
            'call_ms': med('kernel_call_ms', 'kernel_again_call_ms'),
            'plain_ms': med('plain_call_ms'),
            'rfft_only_ms': med('rfft_call_ms'),
            'rfft_device_ms': med('rfft_device_ms'),
            'turns': turns}


def check_kernel(dev):
    """Phase 3: the kernel against its plain version and ``fbank_numpy`` at
    three shapes and from a base pointer at an odd offset. Returns the
    shapes, each with its functions, inputs and errors, for phase 5."""
    fixture = np.load(fx.OUT)
    shapes = []

    # the main path's shape: one 10,960-sample streaming window, stride 160
    win = fixture['pcm'][:10960].astype(np.float32)
    wav = torch.from_numpy(win).to(dev)
    frames = F.frame_torch(wav[None], 400, 160, 67)[0].contiguous()
    shapes.append(dict(shape='window N=67 stride 160', n_frames=67,
                       frame_stride=160, samples=win.size, frames=frames,
                       kernel=lambda w=wav: fbank_cuda.fbank_window(w, 67),
                       plain=lambda f=frames: F.fbank_frames_torch(f),
                       host=F.fbank_numpy(win), iters=200))

    # odd frame count, stride 160
    odd = fx.speechlike(159760, seed=11)
    wav = torch.from_numpy(odd).to(dev)
    frames = F.frame_torch(wav[None], 400, 160, 997)[0].contiguous()
    shapes.append(dict(shape='odd N=997 stride 160', n_frames=997,
                       frame_stride=160, samples=odd.size, frames=frames,
                       kernel=lambda w=wav: fbank_cuda.fbank_window(w, 997),
                       plain=lambda f=frames: F.fbank_frames_torch(f),
                       host=F.fbank_numpy(odd), iters=200))

    # bench.py's batch: 16 × 10 s, frames [15,968, 400], stride 400
    batch = [fx.speechlike(160000, seed=s) for s in range(16)]
    frames = torch.cat([F.frame_torch(torch.from_numpy(w).to(dev)[None], 400,
                                      160, 998)[0] for w in batch]).contiguous()
    shapes.append(dict(shape='batch N=15968 stride 400',
                       n_frames=frames.shape[0], frame_stride=400,
                       samples=frames.numel(), frames=frames,
                       kernel=lambda f=frames: fbank_cuda.fbank_frames(f),
                       plain=lambda f=frames: F.fbank_frames_torch(f),
                       host=np.concatenate([F.fbank_numpy(w) for w in batch]),
                       iters=50))

    # predict_batch's device frontend: one stride-160 launch over 16 rows of
    # 80,000 samples, 7,998 frames of the flat buffer, 16 × 498 of them kept
    rows = np.stack([fx.speechlike(80000, seed=100 + s) for s in range(16)])
    wavs = torch.from_numpy(rows).to(dev)
    lens = torch.full((16,), 80000, dtype=torch.int32, device=dev)
    frames = F.frame_torch(wavs.view(1, -1), 400, 160, 7998)[0].contiguous()
    shapes.append(dict(shape='batch path N=7998 stride 160',
                       n_frames=7998, frame_stride=160, samples=rows.size,
                       frames=frames,
                       kernel=lambda: fbank_cuda.fbank_batch(wavs, lens)[0],
                       plain=lambda: F.fbank_batch_torch(wavs, lens)[0],
                       host=np.stack([F.fbank_numpy(w) for w in rows]),
                       iters=50))

    for case in shapes:
        case['errors'] = compare(case['shape'], case['kernel'](),
                                 case['plain'](), case.pop('host'))

    # the 997 frames again from a view one sample into its storage, which
    # the kernel reads with 4-byte loads
    shifted = torch.from_numpy(np.concatenate([[0.0], odd]).astype(
        np.float32)).to(dev)[1:]
    compare('odd offset N=997 stride 160',
            fbank_cuda.fbank_window(shifted, 997),
            F.fbank_frames_torch(F.frame_torch(shifted[None], 400, 160,
                                               997)[0]), F.fbank_numpy(odd))
    return shapes


def time_kernel(shapes):
    """Phase 12: the timings of every shape of phase 3, beside its bound;
    returns the table entry."""
    rows = []
    for case in shapes:
        b_ms, b_by = bound_ms(case['n_frames'], case['samples'])
        row = {k: case[k] for k in ('shape', 'n_frames', 'frame_stride')}
        row.update(bound_ms=b_ms, bound_by=b_by, **case['errors'],
                   **time_shape(case['shape'], case['kernel'], case['plain'],
                                case['frames'], case['iters']))
        print(f"  {row['shape']}: kernel device {row['device_ms']:.6f} ms, "
              f"per call {row['call_ms']:.6f} ms; "
              f"plain {row['plain_ms']:.6f} ms; rfft alone "
              f"{row['rfft_only_ms']:.6f} ms per call, "
              f"{row['rfft_device_ms']:.6f} ms on the device; bound "
              f"{b_ms:.7f} ms ({b_by}); medians of 3 rounds", flush=True)
        rows.append(row)
    main = rows[0]
    return {
        'name': 'fbank', 'route': 'cuda',
        'source': 'ppasr_tpu_torch/csrc/fbank.cu',
        'replaces': 'ppasr_tpu/ops/fbank_pallas.py:65',
        'tpu_function': '_fbank_kernel',
        'launches': None,
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': main['call_ms'], 'call_ms': main['call_ms'],
        'device_ms': main['device_ms'], 'plain_ms': main['plain_ms'],
        'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
        'library_ms': None, 'rfft_only_ms': main['rfft_only_ms'],
        'shape': 'one streaming window: 67 frames at stride 160',
        'shapes': rows,
    }


def tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def main_path(card):
    """Phase 4: the flagship streaming predictor on the card, under the
    process' TF32 flags as it started."""
    flags = tf32_flags()
    print(f"  TF32 flags as a user gets them: matmul {flags[0]}, cuDNN "
          f"{flags[1]}; the predictor turns both off for its calls",
          flush=True)
    data = np.load(fx.OUT)
    pcms = np.split(data['pcm'], np.cumsum(data['lengths'])[:-1])
    piece = int(data['piece'])
    artifact = fx.flagship_artifact(os.path.join(BUILD,
                                                 'torch_smoke_artifact'))
    t0 = time.time()
    pred = PPASRPredictor(model_path=artifact, use_gpu=True,
                          use_device_frontend=True)
    print(f"  predictor built and warmed up in {time.time() - t0:.2f} s on "
          f"{pred.device}", flush=True)

    fbank_cuda.launches = 0
    offline, stream = [], []
    t_off = t_stream = 0.0
    for pcm in pcms:
        t0 = time.time()
        offline.append(pred.predict(pcm)['text'])
        torch.cuda.synchronize()
        t_off += time.time() - t0
        t0 = time.time()
        stream.append(fx.stream_text(pred, pcm, piece))
        torch.cuda.synchronize()
        t_stream += time.time() - t0
    launches = fbank_cuda.launches

    windows = sum(max(0, (len(p) - pred._win_samples)
                      // pred._stride_samples + 1) for p in pcms)
    audio_s = sum(len(p) for p in pcms) / 16000.0
    texts = [str(t) for t in data['texts']]
    errors = sum(edit_distance(h, r) for h, r in zip(stream, texts))
    stream_cer = errors / sum(len(r) for r in texts)
    for t, o, s in zip(texts, offline, stream):
        print(f"  ref {t} | offline {o} | stream {s}", flush=True)
    print(f"  on {card}: streaming CER {stream_cer:.4f} over {len(texts)} "
          f"utterances, {audio_s:.3f} s of audio; real-time factor offline "
          f"{t_off / audio_s:.4f}, streaming {t_stream / audio_s:.4f}; "
          f"fbank launches {launches} for {windows} windows", flush=True)
    if offline != [str(t) for t in data['jax_offline']]:
        raise AssertionError(f"offline transcripts differ from JAX: {offline}")
    if stream != [str(t) for t in data['jax_stream']]:
        raise AssertionError(f"streaming transcripts differ from JAX: {stream}")
    if windows == 0 or launches != windows:
        raise AssertionError(f"fbank kernel launched {launches} times for "
                             f"{windows} streamed windows")
    if tf32_flags() != flags:
        raise AssertionError(f"the predictor left TF32 flags {tf32_flags()}"
                             f", not {flags}")

    # outputs well formed: finite CTC posteriors of the expected shape
    feat = pred.audio_featurizer.featurize(pred._load_audio(pcms[0]))
    padded, t = pred._pad_bucket(feat)
    with torch.inference_mode(), ieee_float32():
        probs, olens = pred.model.get_encoder_out(
            torch.from_numpy(padded).to(pred.device),
            torch.tensor([t], device=pred.device))
    n = int(olens[0])
    out_len = pred.model.encoder.out_len
    if not (probs.shape == (1, out_len(padded.shape[1]), pred.vocab_size)
            and n == out_len(t)
            and torch.isfinite(probs).all()
            and (probs[0, :n].sum(-1) - 1).abs().max().item() < 1e-4):
        raise AssertionError(f"bad posteriors: shape {tuple(probs.shape)}")
    return launches, pred, artifact, data, pcms


def expect(name, got, data, key):
    """Raise unless the texts ``got`` equal the fixture's JAX texts."""
    want = [str(t) for t in data[key]]
    if got != want:
        raise AssertionError(f"{name} transcripts differ from JAX's "
                             f"({key}): {got} != {want}")


def batch_path(card, pred, artifact, data, pcms):
    """Phase 5: ``predict_batch`` on both frontends over five utterances;
    one fbank launch for the device-frontend batch; then the batch launch
    against its plain version on the same CUDA batch. Returns the
    launches of the device-frontend call and that check's max |Δ|."""
    utts = fx.batch_utts(pcms)
    audio_s = sum(len(u) for u in utts) / 16000.0
    host = PPASRPredictor(model_path=artifact, use_gpu=True)
    wav_batch, wlens = pred._waveform_batch(utts)

    fbank_cuda.launches = 0
    t0 = time.time()
    device_out = pred.predict_batch(utts)
    torch.cuda.synchronize()
    t_device = time.time() - t0
    launches = fbank_cuda.launches
    t0 = time.time()
    host_out = host.predict_batch(utts)
    torch.cuda.synchronize()
    t_host = time.time() - t0
    host_launches = fbank_cuda.launches - launches

    for d, h in zip(device_out, host_out):
        print(f"  device frontend {d['text']} ({d['score']:.4f}) | host "
              f"frontend {h['text']} ({h['score']:.4f})", flush=True)
    print(f"  on {card}: {len(utts)} utterances, {audio_s:.3f} s of audio "
          f"in a [rows, samples] = {list(wav_batch.shape)} batch; wall "
          f"{t_device:.4f} s on the device frontend, {t_host:.4f} s on the "
          f"host frontend; fbank launches {launches} and {host_launches}",
          flush=True)
    expect('device-frontend predict_batch', [r['text'] for r in device_out],
           data, 'jax_batch_device')
    expect('host-frontend predict_batch', [r['text'] for r in host_out],
           data, 'jax_batch')
    if launches != 1 or host_launches != 0:
        raise AssertionError(f"predict_batch launched the fbank kernel "
                             f"{launches} times on the device frontend and "
                             f"{host_launches} on the host frontend, not 1 "
                             f"and 0")
    if not all(np.isfinite(r['score']) for r in device_out + host_out):
        raise AssertionError("predict_batch gave a score that is not finite")

    wavs = torch.from_numpy(wav_batch).to(pred.device)
    lens = torch.from_numpy(wlens).to(pred.device)
    got, got_lens = fbank_cuda.fbank_batch(wavs, lens)
    want, want_lens = F.fbank_batch_torch(wavs, lens)
    d = (got - want).abs()
    print(f"  fbank_batch on the card, {tuple(wavs.shape)} → "
          f"{tuple(got.shape)}: vs fbank_batch_torch max "
          f"{d.max().item():.3g} mean {d.mean().item():.3g}; frame counts "
          f"{got_lens.tolist()}", flush=True)
    if not (torch.equal(got_lens, want_lens) and torch.isfinite(got).all()
            and d.max().item() < MAX_TOL and d.mean().item() < MEAN_TOL):
        raise AssertionError(f"fbank_batch disagrees with fbank_batch_torch:"
                             f" frame counts {got_lens.tolist()} vs "
                             f"{want_lens.tolist()}, max "
                             f"{d.max().item():.3g}")
    return launches, d.max().item()


def engine_path(card, pred, data, pcms):
    """Phase 6: the multi-stream engine, three staggered streams."""
    engine = StreamingBatchEngine(pred, max_streams=4)
    t0 = time.time()
    texts = fx.engine_texts(engine, pcms, int(data['piece']))
    torch.cuda.synchronize()
    wall = time.time() - t0
    audio_s = sum(len(p) for p in pcms) / 16000.0
    print(f"  engine texts {texts}", flush=True)
    if engine.ticks == 0:
        raise AssertionError("the engine ran no tick")
    per_tick = wall / engine.ticks * 1e3
    step = engine.tick_seconds / engine.ticks * 1e3
    print(f"  on {card}: {audio_s:.3f} s of audio in 3 staggered streams, "
          f"{engine.ticks} ticks; wall {wall:.4f} s, {per_tick:.3f} ms per "
          f"tick with the host featurizing, {step:.3f} ms per tick in the "
          f"chunk step and its round trip", flush=True)
    expect('engine', texts, data, 'jax_engine')


def timed(fn):
    """(fn(), wall seconds, the card synchronised after)."""
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def expect_beam(name, results, data, key):
    """Raise unless the beam results equal the fixture's JAX texts, with
    every score within fx.BEAM_SCORE_TOL of JAX's."""
    expect(name, [r['text'] for r in results], data, key)
    dscore = np.abs(np.array([r['score'] for r in results])
                    - data[key + '_scores']).max()
    print(f"  {name}: texts equal to {key}, max |Δscore| {dscore:.3g}",
          flush=True)
    if not dscore <= fx.BEAM_SCORE_TOL:
        raise AssertionError(f"{name} scores differ from JAX's ({key}) by "
                             f"{dscore}, above {fx.BEAM_SCORE_TOL}")


def beam_step_bound_ms(rows, dec):
    """Least time for one 'match' step of the beam on this card class: the
    larger of the bytes it must move (each row's state read and written,
    its frame's candidates read, one displacement, fingerprint and value
    gathered for each of the K·N extends at each LM order above 1, and one
    more for each beam's backoff) over the memory rate, and its fp32
    operations (the [K·N, K] hash compare, masked max, exp and sum, five
    per entry) over the fp32 peak."""
    k, n, u = dec.beam_size, dec.cutoff_top_n, dec.max_prefix_len
    orders = dec.lm_hash.order - 1 if dec.lm_hash is not None else 0
    state = k * u * 4 + k * 8 * 3 + k * 4 * 2
    nbytes = rows * (2 * state + 4 + n * 12 + orders * (k * n + k) * 20)
    ops = rows * 5 * k * n * k
    return max(nbytes / PEAK_BYTES, ops / PEAK_FP32_FLOPS) * 1e3


def profile_batch_decode(card, pred, pcms):
    """One torch.profiler session (CUDA activity only) over one batch
    decode from the CTC logits of the five utterances' host features:
    device time and launches, each per scan step; and the wall per call."""
    dec = pred._beam_decoder
    utts = fx.batch_utts(pcms)
    x, lens = fx.host_features(pred, utts)
    with torch.inference_mode(), ieee_float32():
        logits, olens = pred.model.get_encoder_logits(
            torch.from_numpy(x).to(pred.device),
            torch.from_numpy(lens).to(pred.device))
        decode = lambda: dec.decode_batch_from_logits(logits, olens)  # noqa
        dec.frames_decoded = 0
        decode()
        steps = dec.frames_decoded
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            decode()
            torch.cuda.synchronize()
        wall_ms = call_ms(decode, 5, warmup=1)
    total_us, kernels = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total_us += evt.self_device_time_total
            kernels += evt.count
    if total_us <= 0 or steps == 0:
        raise AssertionError(f"the profiler recorded {total_us} µs over "
                             f"{steps} scan steps")
    print(f"  on {card}: one batch decode of {len(utts)} utterances, logits "
          f"{list(logits.shape)}, {steps} scan steps after compaction: "
          f"{total_us / 1e3:.4f} ms on the device in {kernels} launches "
          f"(phase 1 included), {total_us / 1e3 / steps:.4f} ms and "
          f"{kernels / steps:.1f} launches per step (bound of one step "
          f"{beam_step_bound_ms(len(utts), dec):.6f} ms); wall "
          f"{wall_ms:.4f} ms per call", flush=True)


def beam_path(card, artifact, data, pcms):
    """Phase 8: the flagship's beam search on the card. Returns the fbank
    launches of its streamed windows and its device-frontend batch."""
    conf = fx.beam_conf(str(data['beam_conf']))
    (pred, build_s) = timed(lambda: PPASRPredictor(
        model_path=artifact, use_gpu=True, use_device_frontend=True,
        decoder='ctc_beam_search', decoder_configs=conf))
    dec = pred._beam_decoder
    print(f"  {type(dec).__name__} on {dec.device}: beam {dec.beam_size}, "
          f"{dec.cutoff_top_n} candidates, hash LM of order "
          f"{dec.lm_hash.order} from {data['beam_lm']}; predictor built and "
          f"warmed up in {build_s:.2f} s", flush=True)
    if not (dec.device.type == 'cuda' and dec.lm_hash is not None
            and all(t.is_cuda for t in dec.tensors())):
        raise AssertionError("the beam decoder's LM tables are not on the "
                             "card")

    dec.frames_decoded = 0
    offline, walls = [], []
    for pcm in pcms:
        out, wall = timed(lambda p=pcm: pred.predict(p))
        offline.append(out)
        walls.append(wall)
    off_frames = dec.frames_decoded

    fbank_cuda.launches = 0
    dec.frames_decoded = 0
    stream, calls, t_stream = [], 0, 0.0
    piece = int(data['piece'])
    for pcm in pcms:
        out, wall = timed(lambda p=pcm: fx.stream_result(pred, p, piece))
        stream.append(out)
        calls += -(-len(pcm) // piece)
        t_stream += wall
        if not all(t.is_cuda for t in dec.tensors()) or dec._state is None:
            raise AssertionError("the streaming beam state is not on the "
                                 "card")
    stream_launches = fbank_cuda.launches
    stream_frames = dec.frames_decoded
    windows = sum(max(0, (len(p) - pred._win_samples)
                      // pred._stride_samples + 1) for p in pcms)

    fbank_cuda.launches = 0
    dec.frames_decoded = 0
    batch, t_batch = timed(lambda: pred.predict_batch(fx.batch_utts(pcms)))
    batch_launches = fbank_cuda.launches
    batch_frames = dec.frames_decoded

    for t, o, st in zip(data['texts'], offline, stream):
        print(f"  ref {t} | beam offline {o['text']} ({o['score']:.4f}) | "
              f"beam stream {st['text']} ({st['score']:.4f})", flush=True)
    print(f"  on {card}: wall per call: predict {statistics.mean(walls):.4f}"
          f" s (each {[round(w, 4) for w in walls]}), predict_stream "
          f"{t_stream / calls:.4f} s over {calls} calls, predict_batch "
          f"{t_batch:.4f} s for 5 utterances; frames the scan decoded after "
          f"compaction: {off_frames} offline, {stream_frames} streamed, "
          f"{batch_frames} steps of the batch; fbank launches "
          f"{stream_launches} for {windows} streamed windows and "
          f"{batch_launches} for the batch", flush=True)
    expect_beam('beam predict', offline, data, 'jax_beam_offline')
    expect_beam('beam predict_stream', stream, data, 'jax_beam_stream')
    expect_beam('beam predict_batch', batch, data, 'jax_beam_batch_device')
    if windows == 0 or stream_launches != windows or batch_launches != 1:
        raise AssertionError(f"fbank kernel launched {stream_launches} times "
                             f"for {windows} streamed windows and "
                             f"{batch_launches} for one batch")

    native, t_native = timed(lambda: PPASRPredictor(
        model_path=artifact, use_gpu=True, decoder='ctc_beam_search',
        decoder_configs=dict(conf, backend='native')))
    nat_out, nat_wall = timed(lambda: [native.predict(p) for p in pcms])
    print(f"  native backend ({type(native._beam_decoder).__name__}, g++ "
          f"build and warm-up {t_native:.2f} s): predict {nat_wall / 3:.4f} "
          f"s per call", flush=True)
    expect_beam('native predict', nat_out, data, 'jax_beam_native')

    profile_batch_decode(card, pred, pcms)
    return stream_launches + batch_launches


def profile_ms(fn):
    """(device milliseconds, kernel launches) of one call of ``fn()``: one
    torch.profiler session recording CUDA activity only, after a warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us, launches = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total_us += evt.self_device_time_total
            launches += evt.count
    if total_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return total_us / 1e3, launches


def stream_windows(pred, pcms):
    return sum(max(0, (len(p) - pred._win_samples) // pred._stride_samples
                   + 1) for p in pcms)


def rescore_path(card, artifact, data, pcms):
    """Phase 9: attention rescoring at the flagship's beam conf on the card
    through predict, predict_batch, predict_stream (device frontend) and
    the engine; texts equal to the fixture's JAX rescoring texts, scores
    within BEAM_SCORE_TOL. Returns the fbank launches of its streamed
    windows and its batch."""
    conf = fx.beam_conf(str(data['beam_conf']))
    pred, build_s = timed(lambda: PPASRPredictor(
        model_path=artifact, use_gpu=True, use_device_frontend=True,
        decoder='attention_rescoring', decoder_configs=conf))
    res = pred._rescorer
    if not (res.device.type == 'cuda' and all(
            p.is_cuda for p in pred.model.decoder.parameters())
            and all(t.is_cuda for t in res.beam.tensors())):
        raise AssertionError("the rescorer or its decoder is not on the "
                             "card")
    print(f"  rescorer on {res.device}: beam {res.beam.beam_size}, "
          f"{res.max_hyp_len}-token hypotheses, ctc_weight "
          f"{res.ctc_weight}, reverse_weight {pred.model.reverse_weight}; "
          f"predictor built and warmed up in {build_s:.2f} s", flush=True)

    offline, walls = [], []
    for pcm in pcms:
        out, wall = timed(lambda p=pcm: pred.predict(p))
        offline.append(out)
        walls.append(wall)
    fbank_cuda.launches = 0
    batch, t_batch = timed(lambda: pred.predict_batch(fx.batch_utts(pcms)))
    batch_launches = fbank_cuda.launches
    fbank_cuda.launches = 0
    stream, t_stream = timed(lambda: [fx.stream_result(pred, p)
                                      for p in pcms])
    stream_launches = fbank_cuda.launches
    calls = sum(-(-len(p) // int(data['piece'])) for p in pcms)
    engine, t_engine = timed(lambda: fx.engine_results(
        StreamingBatchEngine(pred, max_streams=4), pcms))
    windows = stream_windows(pred, pcms)
    for r in offline + batch + stream + engine:
        print(f"  {r['text']} ({r['score']:.4f})", flush=True)
    print(f"  on {card}: wall per call: predict {statistics.mean(walls):.4f}"
          f" s (each {[round(w, 4) for w in walls]}), predict_batch "
          f"{t_batch:.4f} s for 5 utterances, predict_stream "
          f"{t_stream / calls:.4f} s over {calls} calls, the engine "
          f"{t_engine:.4f} s for 3 streams; fbank launches "
          f"{stream_launches} for {windows} streamed windows and "
          f"{batch_launches} for the batch", flush=True)
    expect_beam('rescore predict', offline, data, 'jax_rescore_offline')
    expect_beam('rescore predict_batch', batch, data,
                'jax_rescore_batch_device')
    expect_beam('rescore predict_stream', stream, data,
                'jax_rescore_stream')
    expect_beam('rescore engine', engine, data, 'jax_rescore_engine')
    if windows == 0 or stream_launches != windows or batch_launches != 1:
        raise AssertionError(f"fbank kernel launched {stream_launches} times "
                             f"for {windows} streamed windows and "
                             f"{batch_launches} for one batch")

    # one rescoring pass of the first utterance: the whole pass (beam and
    # decoder) and the decoder's scores alone
    x, lens = fx.host_features(pred, pcms[:1])
    with torch.inference_mode(), ieee_float32():
        enc, probs, olens = pred.model.encode_for_rescore(
            torch.from_numpy(x).to(pred.device),
            torch.from_numpy(lens).to(pred.device))
        hyps, hyp_lens, _ = all_hypotheses(
            res.beam.decode_batch_states(probs, olens), res.max_hyp_len)
        whole = lambda: res.decode_batch_rescore(enc, probs, olens)  # noqa
        dec = lambda: pred.model.attention_rescore_scores(  # noqa: E731
            enc, olens, hyps, hyp_lens)
        whole_ms, whole_n = profile_ms(whole)
        dec_ms, dec_n = profile_ms(dec)
        whole_wall, dec_wall = call_ms(whole, 5, 1), call_ms(dec, 5, 1)
    print(f"  on {card}: one rescoring pass over {list(hyps.shape)} "
          f"hypotheses and {list(enc.shape)} encoder frames: "
          f"{whole_ms:.4f} ms on the device in {whole_n} launches, "
          f"{whole_wall:.4f} ms per call; the decoder's scores alone "
          f"{dec_ms:.4f} ms on the device in {dec_n} launches, "
          f"{dec_wall:.4f} ms per call", flush=True)
    return stream_launches + batch_launches


def bf16_path(card, artifact, data, pcms, pred32):
    """Phase 10: compute_dtype='bfloat16' with greedy decoding on the
    device frontend through predict, predict_batch, predict_stream and the
    engine: texts equal to the fixture's JAX bf16 texts under the near-tie
    rule; the CTC log-probs beside the float32 predictor's; wall per call
    beside the float32 path's. Returns the fbank launches of its streamed
    windows and its batch."""
    pred, build_s = timed(lambda: PPASRPredictor(
        model_path=artifact, use_gpu=True, use_device_frontend=True,
        compute_dtype='bfloat16'))
    enc = pred.model.encoder
    if not (enc.dtype == torch.bfloat16 and enc.embed.Dense_0.weight.is_cuda
            and enc.after_norm.weight.dtype == torch.float32):
        raise AssertionError("the bf16 model's weights are not bf16 on the "
                             "card")
    print(f"  bf16 predictor built and warmed up in {build_s:.2f} s",
          flush=True)
    runs = {
        'offline': lambda p: [p.predict(u)['text'] for u in pcms],
        'batch_device': lambda p: [r['text'] for r in p.predict_batch(
            fx.batch_utts(pcms))],
        'stream': lambda p: [fx.stream_text(p, u) for u in pcms],
        'engine': lambda p: fx.engine_texts(StreamingBatchEngine(
            p, max_streams=4), pcms),
    }
    calls = {'offline': 3, 'batch_device': 1, 'engine': 3,
             'stream': sum(-(-len(u) // int(data['piece'])) for u in pcms)}
    launches = {}
    for name, run in runs.items():
        key = f'jax_bf16_{name}'
        fbank_cuda.launches = 0
        with fx.PosteriorRecorder(predict_module, greedy_module) as rec:
            texts, wall = timed(lambda: run(pred))
        launches[name] = fbank_cuda.launches
        _, wall32 = timed(lambda: run(pred32))
        bad = fx.near_tie_failures(
            texts, [str(t) for t in data[key]], [u[0] for u in rec.utts],
            data[key + '_ids'], data[key + '_margins'], data[key + '_frames'])
        how = 'equal to' if texts == [str(t) for t in data[key]] \
            else 'within the near-tie rule of'
        print(f"  bf16 {name}: {texts}, {how} {key}; wall per call "
              f"{wall / calls[name]:.4f} s in bf16, "
              f"{wall32 / calls[name]:.4f} s in float32", flush=True)
        if bad:
            raise AssertionError(f"bf16 {name} texts differ from JAX's "
                                 f"beyond near ties: {bad}")
    windows = stream_windows(pred, pcms)
    if launches['stream'] != windows or launches['batch_device'] != 1:
        raise AssertionError(f"fbank kernel launched {launches} times for "
                             f"{windows} streamed windows and one batch")

    x, lens = fx.host_features(pred, pcms)
    with torch.inference_mode(), ieee_float32():
        args = (torch.from_numpy(x).to(pred.device),
                torch.from_numpy(lens).to(pred.device))
        lp16, olens = pred.model.get_ctc_log_probs(*args)
        lp32, _ = pred32.model.get_ctc_log_probs(*args)
    valid = torch.arange(lp16.shape[1], device=pred.device)[None, :] \
        < olens[:, None]
    d = (lp16 - lp32).abs()[valid]
    print(f"  on {card}: bf16 CTC log-probs against the port's float32 on "
          f"the card: max |Δ| {d.max().item():.4f}, mean "
          f"{d.mean().item():.4f} over {int(valid.sum())} frames",
          flush=True)
    if not (torch.isfinite(lp16).all() and lp16.dtype == torch.float32):
        raise AssertionError("bf16 CTC log-probs are not finite float32")
    return launches['stream'] + launches['batch_device']


def long_path(card, pred, data, pcms):
    """Phase 11: predict_long on the three utterances with quiet between
    them, the float32 device-frontend predictor, without and with
    punctuation and ITN; the VAD's timestamps and the texts equal the
    fixture's JAX ones; the Silero LSTM and the punctuation model on the
    card. Returns the fbank launches (one per batch)."""
    wav = fx.long_recording(pcms)
    fbank_cuda.launches = 0
    plain, t_plain = timed(lambda: pred.predict_long(wav))
    marked, t_marked = timed(lambda: pred.predict_long(wav, use_pun=True,
                                                       is_itn=True))
    launches = fbank_cuda.launches
    stamps = pred._vad.get_speech_timestamps(wav.astype(np.float32)
                                             / 32768.0)
    net = pred._vad.model.net
    vad_on_card = all(t.is_cuda for t in list(net.parameters())
                      + list(net.buffers()))
    pun_on_card = all(p.is_cuda for p in
                      pred._pun_predictor.model.parameters())
    print(f"  VAD segments {[[s['start'], s['end']] for s in stamps]} of "
          f"{len(wav)} samples; text {plain['text']} "
          f"({plain['score']:.4f}); with punctuation and ITN "
          f"{marked['text']}", flush=True)
    print(f"  on {card}: wall {t_plain:.4f} s, {t_marked:.4f} s with "
          f"punctuation and ITN, for {len(wav) / 16000:.3f} s of audio; "
          f"Silero LSTM on the card {vad_on_card}, punctuation model on the "
          f"card {pun_on_card}; fbank launches {launches}", flush=True)
    if [[s['start'], s['end']] for s in stamps] != \
            data['jax_long_vad'].tolist():
        raise AssertionError(f"VAD timestamps differ from JAX's: {stamps}")
    for key, got in (('jax_long', plain), ('jax_long_pun_itn', marked)):
        if got['text'] != str(data[key]) or abs(
                got['score'] - float(data[key + '_score'])) > 1e-3:
            raise AssertionError(f"predict_long {got} differs from JAX's "
                                 f"{data[key]}")
    if not (vad_on_card and pun_on_card and launches == 2):
        raise AssertionError(f"VAD on the card {vad_on_card}, punctuation "
                             f"model {pun_on_card}, fbank launches "
                             f"{launches} for two batches")
    return launches


def stream_eval_path(card, pred, data, pcms):
    """Phase 7: the batched streaming eval over the host features."""
    t0 = time.time()
    x, lens = fx.host_features(pred, pcms)
    ids, max_probs, out_lens = streaming_greedy_batch(pred.model, x, lens)
    wall = time.time() - t0
    texts = fx.rows_to_texts(_collapse, ids, max_probs, out_lens,
                             pred.vocab_list)
    refs = [str(t) for t in data['texts']]
    cers = [cer(h, r) for h, r in zip(texts, refs)]
    print(f"  stream eval texts {texts}; out_lens {out_lens.tolist()}",
          flush=True)
    print(f"  on {card}: {x.shape[0]} streams of up to {x.shape[1]} frames "
          f"in {wall:.4f} s; CER {statistics.mean(cers):.4f} (mean of "
          f"{[round(c, 4) for c in cers]})", flush=True)
    expect('stream eval', texts, data, 'jax_stream_eval')


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    t_all = time.time()

    t0 = time.time()
    card = smi_line()
    defaults = tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda:0')
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off for matmul and cuDNN during the "
          f"kernel check", flush=True)
    phase('card', t0)

    t0 = time.time()
    so = fbank_cuda.build(force=True)
    with open(so.with_suffix('.log'), encoding='utf-8') as f:
        report = [line.strip() for line in f
                  if 'registers' in line or 'spill' in line]
    for line in report:
        print(f"  ptxas: {line}", flush=True)
    phase('build', t0)

    t0 = time.time()
    shapes = check_kernel(dev)
    phase('kernel', t0)

    t0 = time.time()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = defaults
    launches, pred, artifact, data, pcms = main_path(card)
    phase('main path', t0)

    t0 = time.time()
    batch_launches, batch_err = batch_path(card, pred, artifact, data, pcms)
    launches += batch_launches
    phase('batch', t0)

    t0 = time.time()
    engine_path(card, pred, data, pcms)
    phase('engine', t0)

    t0 = time.time()
    stream_eval_path(card, pred, data, pcms)
    phase('stream eval', t0)

    t0 = time.time()
    launches += beam_path(card, artifact, data, pcms)
    phase('beam', t0)

    t0 = time.time()
    launches += rescore_path(card, artifact, data, pcms)
    phase('rescore', t0)

    t0 = time.time()
    launches += bf16_path(card, artifact, data, pcms, pred)
    phase('bf16', t0)

    t0 = time.time()
    launches += long_path(card, pred, data, pcms)
    phase('long', t0)

    t0 = time.time()
    entry = time_kernel(shapes)
    entry['launches'] = launches
    entry['max_abs_err'] = max(entry['max_abs_err'], batch_err)
    phase('timing', t0)

    print(f"[total] {time.time() - t_all:.2f} s", flush=True)
    print(json.dumps({'kernels': [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
