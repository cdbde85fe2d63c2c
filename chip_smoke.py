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
12. train (tests/fixtures/torch_train_batch.npz, 8 utterances, and its JAX
   numbers; tolerances from tests/make_torch_train_fixture.py): the
   committed flagship with dropout off, float32 under ``ieee_float32()``:
   the step-0 loss, loss_ctc, loss_att, th_accuracy and gradient norm
   through B1, 3 updates of the flagship's optimizer with accum_grad 2, and
   step 0 again in bf16 (cast at use), each against JAX's;
   ``PPASRTrainer.train`` on the flagship config as committed (bf16 AMP,
   accum_grad 2, the device frontend with dither, SpecAugment and SpecSub,
   the host audio augmentation; overwritten: paths, batch size 2, 2
   epochs, the probe) over the 8 utterances as WAVs: finite losses, a
   checkpoint that ``PPASRPredictor`` loads strictly and runs on the card;
   memorization, a fresh full-width init, 40 updates on the batch: the
   full-context loss must halve; then the timing of the real step (32 ×
   accum_grad 2 utterances of 8 s joined from the fixture's PCM, bf16 and
   float32: 2 warm-up steps, 5 timed, wall per step, audio-s/s, peak
   memory, one ``torch.profiler`` step with its top 10 kernels), and the
   port's CTC loss forward and backward beside ``F.ctc_loss`` at the
   step's shape;
13. zoo (tests/fixtures/torch_zoo.npz and its tolerances in
   tests/make_torch_zoo_fixture.py): DeepSpeech2, the Squeezeformer and the
   EfficientConformer at the full width of configs/deepspeech2.yml,
   squeezeformer.yml and efficient_conformer.yml with the fixture's seeded
   weights (``zf.zoo_artifact``), each through ``PPASRPredictor(use_gpu=
   True, use_device_frontend=True)``: ``predict``, ``predict_stream`` in
   0.16 s pieces (one fbank launch per window), ``predict_batch`` over five
   utterances (one launch) and the engine over three staggered streams,
   greedy; every frame's argmax equal to the fixture's JAX one except
   where JAX's top-2 margin is below ``zf.NEAR_TIE``, texts equal under
   that rule; the first CTC log-prob rows within ``zf.LOGPROB_TOL``; for
   the attention families one ``predict`` with attention rescoring, texts
   equal and scores within ``zf.RESCORE_TOL``; one float32 train step
   (dropout off, B1 without dither, the training fixture's 8 utterances),
   loss terms and gradient norm within ``zf.TRAIN_RTOL`` of JAX's; wall
   per call and per window; and DeepSpeech2 again from its initial weights
   with ``enable_amp`` (its LSTMs in bf16 over float32 weights), one step
   on B1 with the dither, against tests/fixtures/torch_recipe.npz's JAX
   bf16 step within ``tf.BF16_LOSS_RTOL`` / ``tf.BF16_GRAD_NORM_RTOL``;
14. recipe (tests/fixtures/torch_recipe.npz and its tolerances in
   tests/make_torch_recipe_fixture.py), through the CLIs' ``main`` in a
   workspace under build/: the eleven committed utterances (the training
   fixture's 8 as ``train.txt``, the smoke fixture's 3 as ``test.txt``)
   through ``python -m ppasr_tpu_torch.create_data`` with
   configs/conformer.yml (manifests and vocabulary equal JAX's, CMVN
   within 1e-5) and ``extract_features`` for the test split; ``train``
   with the stock configs/conformer.yml at full width (256-dim, 12
   blocks), configs/augmentation.json's host stages, one epoch of batches
   of 4, its evaluate on the stock ``ctc_beam_search`` (beam 300, LM-free:
   the config's .klm is absent): finite losses, a ``best_model``, wall per
   step and the evaluate's audio-s/s; ``eval`` of the committed flagship
   over the eleven, greedy, beam (flagship conf, lm/synth_lm.arpa),
   attention rescoring, and ``streaming_eval`` greedy and beam: texts equal
   JAX's, scores within ``BEAM_SCORE_TOL``; ``export_model`` of the trained
   checkpoint, served by ``PPASRPredictor``: host-frontend
   ``predict_batch`` texts equal the trained model's greedy ``evaluate``,
   device-frontend ``predict_batch`` (one B1 launch) and ``predict_stream``
   (one per window), CTC log-probs of B1's features within 1e-3 of the
   host features';
15. ddp, through ``tests/torch_ddp_worker.py`` (the train CLI's ``main``
   in each rank, a JSON report per rank) in a workspace under build/ on
   the training fixture's 8 utterances and their halves: (a) the
   flagship as committed (256 × 12 blocks, bf16, dropout, B1 with dither,
   SpecAugment, the audio augmentation on the native loader), 2 updates
   of 4 × accum_grad 2, under ``torch.distributed.run --nproc_per_node=1``
   (one NCCL rank, DDP) and without torchrun's environment: losses
   bit-equal, one B1 launch per micro-batch in each; (b) two gloo ranks
   both on cuda:0 (gloo, since the host has fewer cards than ranks)
   against one process with the same global batch, the narrow model in
   float32 with dropout and dither off, SGD with momentum at lr 0.05
   (``dw.PARITY_OPTIMIZER``, so that a wrong gradient moves the weights
   past the tolerance): losses and gradient norms within 1e-5 relative,
   last_model within 1e-5 (its change from the start is far larger), the
   ranks' parameters bit-equal, checkpoints from rank 0 only; (c) the native
   loader built here (g++) on the recipe phase's eleven utterances
   against the Python item path under the same decisions, per transform
   within ``tests/torch_native_util.TOLERANCES``;
16. tp, through ``tests/torch_tp_worker.py`` (one ``torch.distributed.run
   --nproc_per_node=4`` launch, four gloo ranks all on cuda:0, the grids
   made from one process group in one order): the committed flagship at
   full width (256-dim, 12 blocks, 4 heads, 2048 FFN units, the 3 + 3-block
   decoder at 1024, the 425-symbol vocabulary) in float32 with dropout and
   dither off, on the training fixture's 8 utterances as raw audio through
   B1, 2 updates of 4 × accum_grad 2 by SGD with momentum at lr 0.05
   (``dw.PARITY_OPTIMIZER``), at DP2×TP2 and DP1×TP4 (Megatron tensor
   parallelism, ``parallel/tensor_parallel.shard_module``), each against
   the same global batches in this process: losses and gradient norms
   within 1e-5 relative, the whole parameters gathered from the shards
   within 1e-5, replicated parameters bit-equal across each model group;
   then the DP4 beam decode (``parallel/distributed.decode_batch_sharded``,
   two rows a rank, phase 8's beam conf with the trigram) of the
   flagship's posteriors, from probabilities and from logits: texts equal
   to this process's decode, scores within ``BEAM_SCORE_TOL``; wall per
   update at each grid and alone (gloo through the host on one card: no
   measure of NCCL between cards);
17. deploy (tests/fixtures/torch_deploy.npz and its tolerances in
   tests/make_torch_deploy_fixture.py): int8: the committed flagship
   quantized by ``utils/quant``, its dequantized weights bit-equal to the
   JAX package's (the fixture's sha256), ``model.msgpack`` against
   ``model_quant.msgpack`` bytes, and ``PPASRPredictor`` from the int8
   file alone on the device frontend: ``predict`` and ``predict_stream``
   texts equal the JAX ones from its own int8 file, one fbank launch per
   window; programs: ``PPASRTrainer.export(save_stablehlo=True)`` of the
   flagship at full width on the card (CPU and card programs),
   ``InferencePredictor`` serving them with no model code on the
   utterances' host features, offline and in 67-frame chunks: posteriors
   within ``PROGRAM_TOL`` of the model code on the card, greedy texts
   equal JAX's; the other three families' card programs at full width
   (the zoo fixture's seeds) against their model code; export seconds,
   ``.pt2`` sizes and wall per call beside the model code's; server:
   ``infer_server.main`` in this process on free localhost ports (the
   flagship, ``use_gpu``, the device frontend): ``POST /recognition`` per
   utterance and ``/recognition_long_audio`` give the JAX ``predict`` and
   ``predict_long`` texts, ``GET /`` the client page, three concurrent
   WebSocket clients over localhost in 0.16 s pieces the JAX engine texts;
   the long recording's batch is B1's one launch
   (the engine featurizes on the host, as JAX's does); wall per request
   and per streamed piece; ``VADModel``: the fixture's seeded weights on
   the card, probabilities within ``VAD_TOL`` of JAX's;
18. timing, after the paths, whose real-time factors are thus read
   before the process first runs the profiler: at each shape of phase 3,
   three rounds time in turn the kernel, the plain version,
   ``torch.fft.rfft`` alone on the same frames, and the kernel again, each
   per call (``call_ms``, CUDA events around back-to-back calls, host work
   included) and the kernel and ``rfft`` also on the device alone
   (``device_ms``, from ``torch.profiler`` recording CUDA activity only);
   and the bound. The kernel table's ``ms`` is ``call_ms`` at the window,
   its ``launches`` the launches of phases 4, 5, 8–11, 13, 14 and 17 (one
   per streamed window, one per batch) and 12, 13, 15 and 16 (one per
   micro-batch of the training path, and one per decoding rank in 16;
   those of phases 15 and 16 counted in the ranks' processes and reported
   back), and its ``max_abs_err`` the largest of phases 3 and 5.

The line before the last is the card's ``nvidia-smi`` name and power limit,
the one before it the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Everything written goes under
``build/`` (listed in .gitignore).
"""
import asyncio
import http.client as http_client
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

import ppasr_tpu_torch.decoders.greedy as greedy_module
import ppasr_tpu_torch.predict as predict_module
import ppasr_tpu_torch.trainer as trainer_module
from ppasr_tpu_torch import create_data as create_data_cli
from ppasr_tpu_torch import eval as eval_cli
from ppasr_tpu_torch import export_model as export_cli
from ppasr_tpu_torch import extract_features as extract_features_cli
from ppasr_tpu_torch import infer_server
from ppasr_tpu_torch import train as train_cli
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.data import native_pipeline
from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.data.dataset import collate_raw_fn
from ppasr_tpu_torch.decoders.beam_search_torch import all_hypotheses
from ppasr_tpu_torch.decoders.greedy import _collapse
from ppasr_tpu_torch.infer_utils.inference_predictor import InferencePredictor
from ppasr_tpu_torch.infer_utils.torch_export import export_programs
from ppasr_tpu_torch.infer_utils.vad_predictor import VADModel
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.models.streaming_eval import streaming_greedy_batch
from ppasr_tpu_torch.ops import fbank as F
from ppasr_tpu_torch.ops import fbank_cuda
from ppasr_tpu_torch.ops.ctc import ctc_loss_from_logits
from ppasr_tpu_torch.ops.frontend import make_device_frontend
from ppasr_tpu_torch.predict import PPASRPredictor, ieee_float32
from ppasr_tpu_torch.serving import StreamingBatchEngine
from ppasr_tpu_torch.train_state import create_train_state, make_train_step
from ppasr_tpu_torch.trainer import PPASRTrainer
from ppasr_tpu_torch.utils.checkpoint import (convert_params, load_msgpack,
                                              save_msgpack,
                                              write_inference_artifact)
from ppasr_tpu_torch.utils.metrics import cer, edit_distance
from ppasr_tpu_torch.utils.quant import dequantize_params, quantize_params

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, 'tests'))
import make_torch_deploy_fixture as dfx  # noqa: E402  (no JAX at import)
import make_torch_recipe_fixture as rf  # noqa: E402  (no JAX at import)
import make_torch_smoke_fixture as fx  # noqa: E402  (no JAX at import)
import make_torch_train_fixture as tf  # noqa: E402  (no JAX at import)
import make_torch_zoo_fixture as zf  # noqa: E402  (no JAX at import)
import torch_ddp_worker as dw  # noqa: E402  (no JAX)
import torch_native_util as nu  # noqa: E402  (no JAX)
import torch_tp_worker as tw  # noqa: E402  (no JAX)

BUILD = os.path.join(ROOT, 'build')
AUGMENTATION = os.path.join(ROOT, 'configs', 'augmentation.json')

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


def device_ms(fn, iters, launches_per_call, match=None, tries=10):
    """(device milliseconds per call of ``fn()``, launches recorded).
    ``torch.profiler``, recording CUDA activity only, over ``iters`` calls:
    the device time that ``key_averages()`` gives for the kernels whose name
    contains ``match`` (every kernel and copy when ``match`` is None), over
    the launches it recorded, times ``launches_per_call``. A session that
    records no device time, or fewer than half the ``iters *
    launches_per_call`` launches, or more than them, is printed and run
    again, up to ``tries`` sessions; then this raises."""
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
        if total_us > 0 and want / 2 <= seen <= want:
            return total_us / seen * launches_per_call / 1e3, seen
        print(f"  profiler session recorded {seen} of {want} launches; "
              f"run again", flush=True)
    raise RuntimeError(f"torch.profiler recorded {seen} of {want} launches "
                       f"in each of {tries} sessions")


def bound_ms(n_frames, input_samples, num_mel_bins=80, noise_floats=0):
    """Least time for fbank on this card class: the larger of the bytes the
    function must move (samples, the dither's noise where the launch has
    one, window, each filter's band of weights and its int32 band entry
    in, log-mel out) over the memory rate, and the fp32 operations of an
    FFT-based fbank over the fp32 peak (the dither adds one a sample). A
    real n-point FFT counts 2.5·n·log2(n) operations."""
    mel = F.get_mel_banks(num_mel_bins, 512, 16000.0)
    band, weights = fbank_cuda.mel_bands(mel[:, :fbank_cuda.N_BINS])
    nnz = weights.size
    flops_per_frame = (4 * 400              # DC mean, pre-emphasis, window
                       + 2.5 * 512 * 9      # real 512-point FFT
                       + 3 * 257            # power
                       + 2 * nnz            # mel projection
                       + 2 * num_mel_bins)  # floor and log
    nbytes = (4 * (input_samples + noise_floats + 400 + nnz
                   + n_frames * num_mel_bins) + band.nbytes)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (n_frames * flops_per_frame + noise_floats) / PEAK_FP32_FLOPS \
        * 1e3
    return max(t_bytes, t_ops), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def compare(name, got, plain, host, host_name='fbank_numpy'):
    """max/mean |Δ| of the kernel against the plain version and the host
    reference (fbank_numpy); raises outside the bounds."""
    d_plain = (got - plain).abs()
    d_host = (got.cpu() - torch.from_numpy(host)).abs()
    row = {'max_abs_err': d_plain.max().item(),
           'mean_abs_err': d_plain.mean().item(),
           'max_abs_err_numpy': d_host.max().item(),
           'mean_abs_err_numpy': d_host.mean().item()}
    print(f"  {name}: vs plain max {row['max_abs_err']:.3g} mean "
          f"{row['mean_abs_err']:.3g}; vs {host_name} max "
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

    # the training step's launch: fbank_batch over a micro-batch of 32
    # utterances of 8 s in the collate bucket, with the dither's noise
    # [32, T, 400], the same on both sides; the reference is the plain
    # version on the host (fbank_numpy takes no given noise)
    wav, _, wav_lens, _ = long_train_batch(32)
    t_wavs = torch.from_numpy(wav.astype(np.float32)).to(dev)
    t_lens = torch.from_numpy(wav_lens).to(dev)
    k = t_wavs.shape[1] // 160
    noise = torch.randn((32, k - 2, 400), device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
    frames = F.frame_torch(t_wavs.view(1, -1), 400, 160, 32 * k - 2)[0] \
        .contiguous()
    shapes.append(dict(
        shape=f'train N={32 * k - 2} stride 160 with noise',
        n_frames=32 * k - 2, frame_stride=160, samples=t_wavs.numel(),
        noise_floats=noise.numel(), frames=frames,
        kernel=lambda: fbank_cuda.fbank_batch(t_wavs, t_lens,
                                              noise=noise)[0],
        plain=lambda: F.fbank_batch_torch(t_wavs, t_lens, noise=noise)[0],
        host=F.fbank_batch_torch(t_wavs.cpu(), t_lens.cpu(),
                                 noise=noise.cpu())[0].numpy(),
        host_name='the plain version on the host', iters=20))

    for case in shapes:
        case['errors'] = compare(
            case['shape'], case['kernel'](), case['plain'](),
            case.pop('host'), case.pop('host_name', 'fbank_numpy'))

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
    """Phase 18: the timings of every shape of phase 3, beside its bound;
    returns the table entry."""
    rows = []
    for case in shapes:
        b_ms, b_by = bound_ms(case['n_frames'], case['samples'],
                              noise_floats=case.get('noise_floats', 0))
        row = {k: case[k] for k in ('shape', 'n_frames', 'frame_stride')}
        row['noise_floats'] = case.get('noise_floats', 0)
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


# ------------------------------------------------------------------ train

def train_tensors(dev):
    """The training fixture's batch on ``dev``: (wav [8, S] int16, wav_lens,
    text [8, U], text_lens)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in tf.batch(tf.load())]


def flagship_model(dev, dropout=True):
    """The flagship from its committed checkpoint on ``dev`` (float32
    parameters); ``dropout=False`` builds it with every dropout rate 0."""
    conf = load_config(tf.CONFIG)
    enc, dec = dict(conf.encoder_conf), dict(conf.decoder_conf)
    if not dropout:
        enc.update(dropout_rate=0.0, positional_dropout_rate=0.0,
                   attention_dropout_rate=0.0)
        dec.update(dropout_rate=0.0, positional_dropout_rate=0.0,
                   self_attention_dropout_rate=0.0,
                   src_attention_dropout_rate=0.0)
    model = build_model('conformer', 80, len(fx.vocabulary()),
                        streaming=True, encoder_conf=enc, decoder_conf=dec,
                        model_conf=dict(conf.model_conf),
                        mean_istd_path=os.path.join(ROOT, 'dataset',
                                                    'mean_istd.json'))
    return model, conf


def global_norm(tensors):
    return torch.sqrt(sum((t.double() ** 2).sum() for t in tensors)).item()


def check_close(name, got, want, rtol):
    ok = abs(got - want) <= rtol * abs(want)
    print(f"  {name}: port {got:.7f}, JAX {want:.7f}, relative |Δ| "
          f"{abs(got - want) / abs(want):.3g} (tolerance {rtol:g})",
          flush=True)
    if not (ok and np.isfinite(got)):
        raise AssertionError(f"{name} disagrees with the fixture's JAX value")


def train_parity(card, dev):
    """Train phase, step 1: the committed flagship, dropout off, no dither
    or augmentation, float32 under ``ieee_float32()``: the step-0 loss
    terms, token accuracy and gradient norm over the fixture's 8
    utterances through B1, then 3 updates of the flagship's optimizer with
    accum_grad 2, then step 0 again computing in bf16 (cast at use),
    each against the fixture's JAX numbers."""
    data = tf.load()
    wav, wav_lens, text, text_lens = train_tensors(dev)
    n_tokens = int(text_lens.sum()) + tf.N_UTTS
    frontend = make_device_frontend({'n_mels': 80})
    state_dict = convert_params(load_msgpack(tf.CHECKPOINT))
    for dtype in ('f32', 'bf16'):
        model, conf = flagship_model(dev)
        model.load_state_dict(state_dict, strict=True)
        model.to(dev).eval()
        if dtype == 'bf16':
            model.set_compute_dtype(torch.bfloat16, at_use=True)
        with ieee_float32():
            feat, feat_lens = frontend(wav, wav_lens, deterministic=True)
            out = model(feat, feat_lens, text, text_lens)
            out['loss'].backward()
        grad_norm = global_norm([p.grad for p in model.parameters()])
        rtol = tf.F32_RTOL if dtype == 'f32' else tf.BF16_LOSS_RTOL
        for k in ('loss', 'loss_ctc', 'loss_att'):
            check_close(f"{dtype} step-0 {k}", out[k].item(),
                        float(data[f'{dtype}_{k}']), rtol)
        check_close(f"{dtype} step-0 gradient norm", grad_norm,
                    float(data[f'{dtype}_grad_norm']),
                    tf.F32_RTOL if dtype == 'f32' else tf.BF16_GRAD_NORM_RTOL)
        acc, want = out['th_accuracy'].item(), float(data[f'{dtype}_th_'
                                                          f'accuracy'])
        print(f"  {dtype} step-0 th_accuracy: port {acc:.6f}, JAX "
              f"{want:.6f} (tolerance one token in {n_tokens})", flush=True)
        if abs(acc - want) > 1.0 / n_tokens + 1e-6:
            raise AssertionError("th_accuracy disagrees with the fixture")

    model, conf = flagship_model(dev)
    model.load_state_dict(state_dict, strict=True)
    model.to(dev)
    start = [p.detach().clone() for p in model.parameters()]
    state = create_train_state(model, dict(conf.optimizer_conf),
                               float(conf.train_conf.grad_clip))
    step = make_train_step(tf.ACCUM, frontend, deterministic=True)
    batch = dict(zip(('wav', 'wav_lens', 'text', 'text_lens'),
                     tf.micro_batches(train_tensors(dev))))
    losses = []
    for k in range(tf.N_UPDATES):
        step(state, batch, k)
        with torch.no_grad(), ieee_float32():
            micro = []
            for i in range(tf.ACCUM):
                feat, feat_lens = frontend(batch['wav'][i],
                                           batch['wav_lens'][i],
                                           deterministic=True)
                micro.append(model(feat, feat_lens, batch['text'][i],
                                   batch['text_lens'][i])['loss'].item())
        losses.append(float(np.mean(micro)))
    for k, (got, want) in enumerate(zip(losses, data['update_losses'])):
        check_close(f"loss after update {k + 1}", got, float(want),
                    tf.UPDATE_RTOL)
    check_close("update norm after 3 updates", global_norm(
        [p.detach() - s for p, s in zip(model.parameters(), start)]),
        float(data['update_norm']), tf.UPDATE_RTOL)


def train_loop(card, dev):
    """Train phase, step 2: ``PPASRTrainer.train`` with the flagship config
    as committed (bf16 AMP, accum_grad 2, the device frontend with dither,
    SpecAugment and SpecSub, the host audio augmentation) on the fixture's
    8 utterances written as WAVs, 2 epochs; then ``PPASRPredictor`` loads
    the written checkpoint strictly and transcribes them on the card."""
    data = tf.load()
    pcms = tf.pcms(data)
    work = tempfile.mkdtemp(prefix='train_smoke_', dir=BUILD)
    try:
        manifest = os.path.join(work, 'manifest.train')
        with open(manifest, 'w', encoding='utf-8') as f:
            for i, (pcm, text) in enumerate(zip(pcms, data['texts'])):
                wav = os.path.join(work, f'{i}.wav')
                AudioSegment.from_ndarray(pcm).to_wav_file(wav)
                f.write(json.dumps({'audio_filepath': wav,
                                    'duration': len(pcm) / 16000,
                                    'text': str(text)},
                                   ensure_ascii=False) + '\n')
        vocab = os.path.join(ROOT, 'dataset', 'vocabulary.txt')
        istd = os.path.join(ROOT, 'dataset', 'mean_istd.json')
        overwrites = ','.join([
            f'dataset_conf.train_manifest={manifest}',
            f'dataset_conf.test_manifest={manifest}',
            f'dataset_conf.dataset_vocab={vocab}',
            f'dataset_conf.mean_istd_path={istd}',
            'dataset_conf.batch_size=2', 'train_conf.max_epoch=2',
            'train_conf.train_probe_size=4'])
        t0 = time.time()
        trainer = PPASRTrainer(tf.CONFIG, use_gpu=True, overwrites=overwrites,
                               data_augment_configs=AUGMENTATION)
        state = trainer.train(save_model_path=os.path.join(work, 'models'),
                              log_dir=os.path.join(work, 'log'))
        torch.cuda.synchronize()
        wall = time.time() - t0
        losses = [float(v) for v in trainer.step_losses]
        print(f"  PPASRTrainer.train on {card}: {len(losses)} updates in 2 "
              f"epochs, {wall:.2f} s; losses {[round(v, 4) for v in losses]}"
              f"; compute {next(state.model.parameters()).dtype} parameters "
              f"in {state.model.encoder.dtype}", flush=True)
        if len(losses) < 4 or not np.isfinite(losses).all():
            raise AssertionError(f"train losses {losses}")
        base = os.path.join(work, 'models', trainer.model_dir_name)
        last = os.path.join(base, 'last_model', 'model.msgpack')
        for path in (last, os.path.join(base, 'best_model', 'model.msgpack'),
                     os.path.join(base, 'last_model', 'optimizer.pt')):
            if not os.path.exists(path):
                raise AssertionError(f"the trainer wrote no {path}")
        artifact = write_inference_artifact(
            os.path.join(work, 'infer'), load_config(tf.CONFIG), last,
            vocab, istd)
        pred = PPASRPredictor(model_path=artifact, use_gpu=True,
                              use_device_frontend=True)
        texts = [pred.predict(p)['text'] for p in pcms]
        print(f"  PPASRPredictor on the written checkpoint, {pred.device}: "
              f"{texts}", flush=True)
        if pred.device.type != 'cuda' or not all(isinstance(t, str)
                                                 for t in texts):
            raise AssertionError("the trained checkpoint did not transcribe "
                                 "on the card")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def memorize(card, dev, updates=40):
    """Train phase, step 3: a fresh full-width init (the JAX model's
    distributions), dropout off, bf16 over float32 parameters, Adam at
    1e-3 after 5 warm-up steps; ``updates`` updates on one batch of the 8
    utterances' B1 features. The full-context loss must fall below half
    its first value."""
    model, conf = flagship_model(dev, dropout=False)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev).set_compute_dtype(torch.bfloat16, at_use=True)
    wav, wav_lens, text, text_lens = train_tensors(dev)
    with ieee_float32():
        feat, feat_lens = make_device_frontend({'n_mels': 80})(
            wav, wav_lens, deterministic=True)
    state = create_train_state(model, {
        'optimizer': 'Adam', 'weight_decay': 1e-6, 'learning_rate': 1e-3,
        'scheduler': 'CosineWithWarmup',
        'scheduler_conf': {'warmup_steps': 5, 'T_max': 10000}}, 5.0)
    batch = {'speech': feat[None], 'speech_lens': feat_lens[None],
             'text': text[None], 'text_lens': text_lens[None]}

    def full_context_loss():
        model.eval()
        with torch.no_grad(), ieee_float32():
            return model(feat, feat_lens, text, text_lens)['loss'].item()
    first = full_context_loss()
    step = make_train_step(1)
    t0 = time.time()
    curve = [step(state, batch, i)['loss'] for i in range(updates)]
    curve = [round(float(v), 3) for v in curve]
    wall = time.time() - t0
    last = full_context_loss()
    print(f"  memorization on {card}: full-context loss {first:.4f} → "
          f"{last:.4f} after {updates} updates ({wall:.2f} s); train losses "
          f"{curve}", flush=True)
    if not (np.isfinite(curve).all() and last < 0.5 * first):
        raise AssertionError(f"the loss did not halve: {first} → {last}")


def long_train_batch(n_rows, seconds=8.0):
    """``n_rows`` utterances of ``seconds`` each, joined from the fixture's
    PCM and its token ids in turn, padded as the trainer pads them."""
    data = tf.load()
    pcms, ids = tf.pcms(data), [
        data['tokens'][i, :int(data['token_lens'][i])]
        for i in range(tf.N_UTTS)]
    n = int(seconds * 16000)
    rows, labels = [], []
    j = 0
    for _ in range(n_rows):
        pcm, lab = [], []
        while sum(len(p) for p in pcm) < n:
            pcm.append(pcms[j % tf.N_UTTS])
            lab.append(ids[j % tf.N_UTTS])
            j += 1
        rows.append((np.concatenate(pcm)[:n].astype(np.float32),
                     np.concatenate(lab).astype(np.int32)))
    return collate_raw_fn(rows)


def profile_step(fn):
    """(device ms, launches, top-10 kernels by device time) of one call of
    ``fn()``, from torch.profiler recording CUDA activity only."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(r[1] for r in rows)
    if total <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    return total / 1e3, sum(r[2] for r in rows), rows[:10]


def train_timing(card, dev, rows=32):
    """Train phase, step 4 (after the paths, so the profiler runs last):
    the flagship's real step, batch 32 × accum_grad 2 of 8 s utterances,
    the device frontend with dither and SpecAugment/SpecSub, in bf16 (the
    recipe) and in float32: 2 warm-up steps, then 5 timed, the wall per
    step, audio-s/s, peak memory, and one profiled step; B1 at this
    step's launch shape with noise; the port's CTC loss beside
    ``F.ctc_loss``."""
    conf = load_config(tf.CONFIG)
    wav, labels, wav_lens, label_lens = long_train_batch(rows * tf.ACCUM)
    batch = {k: torch.from_numpy(v).to(dev).reshape(tf.ACCUM, rows,
                                                    *v.shape[1:])
             for k, v in (('wav', wav), ('wav_lens', wav_lens),
                          ('text', labels), ('text_lens', label_lens))}
    audio_s = float(wav_lens.sum()) / 16000
    with open(AUGMENTATION, encoding='utf-8') as f:
        frontend = make_device_frontend(dict(conf.preprocess_conf),
                                        json.load(f))
    state_dict = convert_params(load_msgpack(tf.CHECKPOINT))
    out = {}
    for name, amp in (('bf16', True), ('float32', False)):
        model, _ = flagship_model(dev)
        model.load_state_dict(state_dict, strict=True)
        model.to(dev)
        if amp:
            model.set_compute_dtype(torch.bfloat16, at_use=True)
        state = create_train_state(model, dict(conf.optimizer_conf), 5.0)
        step = make_train_step(tf.ACCUM, frontend)
        for i in range(2):
            step(state, batch, i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        for i in range(5):
            metrics = step(state, batch, 2 + i)
        torch.cuda.synchronize()
        wall = (time.time() - t0) / 5
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        dev_ms, launches, top = profile_step(
            lambda: step(state, batch, 7))
        loss = float(metrics['loss'])
        print(f"  {name} step on {card}: {rows} × accum {tf.ACCUM} of "
              f"{audio_s / rows / tf.ACCUM:.1f} s utterances, "
              f"{list(wav.shape)} int16 samples: wall {wall * 1e3:.2f} ms "
              f"per step (5 after 2 warm-up), {audio_s / wall:.1f} audio-s/s,"
              f" peak memory {peak:.2f} GiB, loss {loss:.4f}; one profiled "
              f"step {dev_ms:.2f} ms on the device in {launches} launches",
              flush=True)
        for key, us, count in top:
            print(f"    {us / 1e3:9.3f} ms {count:6d}× {key[:100]}",
                  flush=True)
        if not np.isfinite(loss):
            raise AssertionError(f"{name} train step loss {loss}")
        out[name] = dict(wall_ms=wall * 1e3, audio_s_per_s=audio_s / wall,
                         peak_gib=peak, device_ms=dev_ms, launches=launches)
        del model, state
        torch.cuda.empty_cache()

    # the CTC loss at this step's shape: [32, T', V] logits of a micro-batch
    t_out = (((wav.shape[1] // 160 - 2) - 1) // 2 - 1) // 2
    gen = torch.Generator(dev).manual_seed(1)
    logits = torch.randn((rows, t_out, len(fx.vocabulary())), device=dev,
                         generator=gen) * 3
    in_lens = torch.full((rows,), t_out, device=dev)
    text = batch['text'][0]
    text_lens = batch['text_lens'][0]

    def port_ctc():
        x = logits.detach().requires_grad_()
        ctc_loss_from_logits(x, in_lens, text, text_lens).backward()

    def torch_ctc():
        x = logits.detach().requires_grad_()
        (torch.nn.functional.ctc_loss(
            torch.log_softmax(x, -1).transpose(0, 1),
            torch.clamp(text, min=0), in_lens, text_lens,
            reduction='sum') / rows).backward()
    port_ms = call_ms(port_ctc, 10, warmup=2)
    lib_ms = call_ms(torch_ctc, 10, warmup=2)
    port_dev, port_launches, _ = profile_step(port_ctc)
    lib_dev, lib_launches, _ = profile_step(torch_ctc)
    print(f"  CTC loss forward + backward at [{rows}, {t_out}, "
          f"{logits.shape[2]}], U ≤ {text.shape[1]}: the port's "
          f"{port_ms:.3f} ms per call ({port_dev:.3f} ms on the device in "
          f"{port_launches} launches), F.ctc_loss {lib_ms:.3f} ms per call "
          f"({lib_dev:.3f} ms on the device in {lib_launches} launches)",
          flush=True)
    out['ctc'] = dict(port_ms=port_ms, torch_ms=lib_ms, port_device_ms=port_dev,
                      torch_device_ms=lib_dev)
    return out


def train_path(card, dev):
    """Train phase: steps 1–3 (``train_timing`` runs with the timing
    phase). Returns B1's launches on the training path."""
    fbank_cuda.launches = 0
    t0 = time.time()
    train_parity(card, dev)
    print(f"  parity: {time.time() - t0:.2f} s", flush=True)
    t0 = time.time()
    train_loop(card, dev)
    print(f"  train loop: {time.time() - t0:.2f} s", flush=True)
    t0 = time.time()
    memorize(card, dev)
    print(f"  memorization: {time.time() - t0:.2f} s", flush=True)
    launches = fbank_cuda.launches
    print(f"  fbank launches on the training path: {launches}", flush=True)
    if launches == 0:
        raise AssertionError("the training path never launched kernel B1")
    return launches


def zoo_family(card, dev, use_model, data, utts):
    """Zoo phase, one family at its config's full width with the fixture's
    seeded weights: the greedy paths and the CTC log-prob rows (and, for
    the attention families, rescoring) against the fixture's JAX outputs,
    then one float32 train step. Returns the fbank launches of its
    streamed windows, its batch and its training step."""
    artifact = zf.zoo_artifact(use_model, os.path.join(BUILD,
                                                       f'zoo_{use_model}'))
    pred, build_s = timed(lambda: PPASRPredictor(
        model_path=artifact, use_gpu=True, use_device_frontend=True))
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"  {use_model}: {n_params / 1e6:.2f} M parameters on "
          f"{pred.device}; predictor built and warmed up in {build_s:.2f} s",
          flush=True)
    launches, walls = 0, {}
    for path, run in zf.path_runs(pred, StreamingBatchEngine, utts).items():
        before = fbank_cuda.launches
        with fx.PosteriorRecorder(predict_module, greedy_module) as rec:
            texts, walls[path] = timed(run)
        launches += fbank_cuda.launches - before
        key = f'{use_model}_{path}'
        want = [str(t) for t in data[key]]
        bad = zf.frame_failures(texts, rec.utts, want, data[key + '_ids'],
                                data[key + '_margins'],
                                data[key + '_frames'])
        diff = sum(int((np.asarray(u[0]) != 0).sum()) for u in rec.utts)
        print(f"  {path}: {texts}; non-blank frames {diff}", flush=True)
        if bad:
            raise AssertionError(f"{use_model} {path} breaks the near-tie "
                                 f"rule against JAX: {bad}")
    windows = stream_windows(pred, utts)
    if launches != windows + 1:
        raise AssertionError(f"{use_model}: {launches} fbank launches for "
                             f"{windows} streamed windows and one batch")

    feat, t = fx.host_features(pred, utts[:1])
    with torch.inference_mode(), ieee_float32():
        lp, olens = pred.model.get_ctc_log_probs(
            torch.from_numpy(feat).to(dev), torch.from_numpy(t).to(dev))
    rows = lp[0, :zf.N_ROWS].float().cpu().numpy()
    err = float(np.abs(rows - data[f'{use_model}_logprobs']).max())
    if not (torch.isfinite(lp).all() and lp.shape[-1] == pred.vocab_size
            and int(olens[0]) > zf.N_ROWS):
        raise AssertionError(f"{use_model}: bad log-probs {tuple(lp.shape)}")
    audio_s = sum(len(p) for p in utts) / 16000.0
    print(f"  on {card}: CTC log-probs max |Δ| {err:.3g} against JAX "
          f"(tolerance {zf.LOGPROB_TOL:g}); wall per call: predict "
          f"{walls['offline'] / len(utts) * 1e3:.2f} ms, predict_stream "
          f"{walls['stream'] / windows * 1e3:.2f} ms per window "
          f"({windows} windows), predict_batch {walls['batch'] * 1e3:.2f} "
          f"ms for {len(fx.batch_utts(utts))} utterances, engine "
          f"{walls['engine'] * 1e3:.2f} ms for 3 streams; {audio_s:.3f} s "
          f"of audio", flush=True)
    if err > zf.LOGPROB_TOL:
        raise AssertionError(f"{use_model}: CTC log-probs differ from JAX's "
                             f"by {err:.3g}")
    del pred

    if use_model in zf.RESCORED:
        res, _ = timed(lambda: PPASRPredictor(
            model_path=artifact, use_gpu=True,
            decoder='attention_rescoring',
            decoder_configs=dict(zf.RESCORE_CONF)))
        out, wall = timed(lambda: [res.predict(p) for p in utts])
        want = [str(t) for t in data[f'{use_model}_rescore']]
        want_s = data[f'{use_model}_rescore_scores']
        d = [abs(r['score'] - float(w)) for r, w in zip(out, want_s)]
        print(f"  rescoring: {[r['text'] for r in out]}; max |Δscore| "
              f"{max(d):.3g} (tolerance {zf.RESCORE_TOL:g}); wall per call "
              f"{wall / len(utts) * 1e3:.2f} ms", flush=True)
        if max(d) > zf.RESCORE_TOL or any(
                r['text'] != w for r, w in zip(out, want)):
            raise AssertionError(f"{use_model} rescoring differs from JAX: "
                                 f"{out} != {want} / {want_s.tolist()}")
        del res

    model, conf = zf.zoo_model(use_model)
    model.to(dev)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, dict(conf.optimizer_conf),
                               float(conf.train_conf.grad_clip))
    step = make_train_step(1, make_device_frontend({'n_mels': 80}),
                           deterministic=True)
    batch = dict(zip(('wav', 'wav_lens', 'text', 'text_lens'),
                     [t[None] for t in train_tensors(dev)]))
    before = fbank_cuda.launches
    metrics, wall = timed(lambda: step(state, batch, 0))
    launches += fbank_cuda.launches - before
    print(f"  train step (float32, dropout off, B1 without dither, 8 "
          f"utterances): {wall * 1e3:.1f} ms", flush=True)
    names = ('loss', 'loss_ctc', 'grad_norm') if use_model == 'deepspeech2' \
        else ('loss', 'loss_ctc', 'loss_att', 'grad_norm')
    for k in names:
        check_close(f"{use_model} step-0 {k}", metrics[k].item(),
                    float(data[f'{use_model}_{k}']), zf.TRAIN_RTOL)
    if use_model == 'deepspeech2':
        launches += ds2_bf16_step(model, conf, initial, batch)
    del model, state
    torch.cuda.empty_cache()
    return launches


def ds2_bf16_step(model, conf, initial, batch):
    """Zoo phase, DeepSpeech2 with ``enable_amp``: the initial weights
    again, the LSTMs computing in bf16 over float32 parameters (cast at
    use), one step on B1 with the dither; loss terms and gradient norm
    against the JAX bf16 step of tests/fixtures/torch_recipe.npz (taken
    without dither) within tf.BF16_LOSS_RTOL / tf.BF16_GRAD_NORM_RTOL.
    Returns its fbank launches."""
    model.load_state_dict(initial)
    model.set_compute_dtype(torch.bfloat16, at_use=True)
    state = create_train_state(model, dict(conf.optimizer_conf),
                               float(conf.train_conf.grad_clip))
    step = make_train_step(1, make_device_frontend({'n_mels': 80}))
    before = fbank_cuda.launches
    metrics, wall = timed(lambda: step(state, batch, 0))
    launches = fbank_cuda.launches - before
    data = np.load(rf.OUT)
    rnn = model.encoder.fwd_rnns[0]
    print(f"  bf16 train step (enable_amp: {rnn.compute_dtype} cells over "
          f"{rnn.weight_ih_l0.dtype} weights, B1 with dither): "
          f"{wall * 1e3:.1f} ms", flush=True)
    for k, rtol in (('loss', tf.BF16_LOSS_RTOL),
                    ('loss_ctc', tf.BF16_LOSS_RTOL),
                    ('grad_norm', tf.BF16_GRAD_NORM_RTOL)):
        check_close(f"deepspeech2 bf16 step-0 {k}", metrics[k].item(),
                    float(data[f'ds2_bf16_{k}']), rtol)
    if launches != 1 or rnn.compute_dtype != torch.bfloat16:
        raise AssertionError(f"the DS2 bf16 step launched B1 {launches} "
                             f"times in {rnn.compute_dtype}")
    return launches


def zoo_path(card, dev):
    """Phase 13: the three other families through every entry point and
    the trainer (``zoo_family``). Returns their fbank launches."""
    data = np.load(zf.OUT)
    utts = zf.pcms()
    launches = 0
    for use_model in zf.FAMILIES:
        t0 = time.time()
        launches += zoo_family(card, dev, use_model, data, utts)
        print(f"  {use_model}: {time.time() - t0:.2f} s", flush=True)
    print(f"  fbank launches on the zoo paths: {launches}", flush=True)
    return launches


def recipe_data(card, work, data):
    """Recipe phase, step 1: the eleven utterances as an annotation
    directory, ``python -m ppasr_tpu_torch.create_data`` with
    configs/conformer.yml pointed at the workspace, held to the fixture's
    JAX manifests, vocabulary and CMVN; then ``extract_features`` for the
    test split. Returns the overwrites that point the config at ``work``."""
    annotation = rf.write_corpus(work)
    overwrites = rf.workspace_overwrites(work)
    _, create_s = timed(lambda: create_data_cli.main([
        '--configs', rf.STOCK_CONFIG, '--annotation_path', annotation,
        '--noise_dir', '', '--overwrites', overwrites]))
    for split in ('train', 'test'):
        got = rf.masked_lines(os.path.join(work, f'manifest.{split}'), work)
        if got != [str(v) for v in data[f'manifest_{split}']]:
            raise AssertionError(f"manifest.{split} differs from JAX's: "
                                 f"{got}")
    with open(os.path.join(work, 'vocabulary.txt'), encoding='utf-8') as f:
        vocab = f.read()
    if vocab != str(data['vocabulary']):
        raise AssertionError(f"the vocabulary differs from JAX's: {vocab!r}")
    cmvn = rf.read_cmvn(os.path.join(work, 'mean_istd.json'))
    err = max(float(np.max(np.abs(g - data[k]) / np.abs(data[k])))
              for g, k in zip(cmvn, ('mean', 'istd')))
    _, extract_s = timed(lambda: extract_features_cli.main([
        '--configs', rf.STOCK_CONFIG, '--save_dir',
        os.path.join(work, 'features'), '--splits', 'test',
        '--overwrites', overwrites]))
    print(f"  create_data: manifests of 8 + 3 utterances and the "
          f"vocabulary equal JAX's, CMVN within {err:.3g} relative "
          f"(tolerance {rf.CMVN_RTOL:g}); host seconds: create_data "
          f"{create_s:.2f}, extract_features (test) {extract_s:.2f}",
          flush=True)
    if err > rf.CMVN_RTOL or not os.path.exists(
            os.path.join(work, 'manifest_features.test')):
        raise AssertionError("mean_istd.json or the test features are off")
    return overwrites


def recipe_train(card, work, overwrites):
    """Recipe phase, step 2: ``python -m ppasr_tpu_torch.train`` with the
    stock configs/conformer.yml at its full width (plus ``profile_steps:
    [0, 1]``, which the overwrites cannot set), configs/augmentation.json
    (host SpecAugment and SpecSub), one epoch of batches of 4 (accum_grad 1:
    the stock 4 would need 16 utterances a step); its per-epoch evaluate
    runs the config's ctc_beam_search (beam 300, the absent .klm decoded
    LM-free); the profiler's trace must hold CUDA kernels. Returns the best
    checkpoint's directory."""
    config = os.path.join(work, 'conformer.yml')
    with open(rf.STOCK_CONFIG, encoding='utf-8') as f:
        text = f.read()
    with open(config, 'w', encoding='utf-8') as f:
        f.write(text.replace('\ntrain_conf:\n',
                             '\ntrain_conf:\n  profile_steps: [0, 1]\n'))
    evals, steps = [], []
    evaluate = PPASRTrainer.evaluate
    make_step = trainer_module.make_train_step

    def timed_evaluate(self, *args, **kw):
        out, wall = timed(lambda: evaluate(self, *args, **kw))
        evals.append((self, wall, len(self.eval_results)))
        return out

    def timed_make_step(*args, **kw):
        step = make_step(*args, **kw)

        def run(*a):
            out, wall = timed(lambda: step(*a))
            steps.append(wall)
            return out
        return run

    PPASRTrainer.evaluate = timed_evaluate
    trainer_module.make_train_step = timed_make_step
    try:
        state, wall = timed(lambda: train_cli.main([
            '--configs', config, '--save_model_path',
            os.path.join(work, 'models'), '--log_dir',
            os.path.join(work, 'log'), '--augment_conf_path', AUGMENTATION,
            '--overwrites', overwrites + ',dataset_conf.batch_size=4,'
            'train_conf.accum_grad=1,train_conf.max_epoch=1']))
    finally:
        PPASRTrainer.evaluate = evaluate
        trainer_module.make_train_step = make_step
    trainer = evals[0][0]
    losses = [float(v) for v in trainer.step_losses]
    test_wall = evals[0][1]
    test_audio = sum(len(p) for p, _, split in rf.utterances()
                     if split == 'test') / 16000.0
    decoder = type(trainer._eval_decoder).__name__
    n_params = sum(p.numel() for p in state.model.parameters())
    enc = trainer.configs.encoder_conf
    print(f"  train CLI on {card}: {n_params / 1e6:.2f} M parameters "
          f"({enc.output_size}-dim, {enc.num_blocks} blocks), "
          f"{len(losses)} updates, losses {[round(v, 4) for v in losses]}; "
          f"wall per step {[round(w, 3) for w in steps]} s (batches of 4, "
          f"host features with SpecAugment and SpecSub), the CLI "
          f"{wall:.2f} s; evaluate with {decoder} "
          f"(beam {trainer._eval_decoder.beam_size}) on the test split: "
          f"{test_wall:.3f} s, {test_audio / test_wall:.1f} audio-s/s",
          flush=True)
    if len(losses) != 2 or not np.isfinite(losses).all() or \
            decoder != 'TorchBeamSearchDecoder' or evals[0][2] != 3:
        raise AssertionError(f"recipe training: losses {losses}, decoder "
                             f"{decoder}")
    best = os.path.join(work, 'models', trainer.model_dir_name, 'best_model')
    if not os.path.exists(os.path.join(best, 'model.msgpack')):
        raise AssertionError(f"the train CLI wrote no {best}")
    with open(os.path.join(work, 'log', 'profile', 'trace.json'),
              encoding='utf-8') as f:
        events = json.load(f)['traceEvents']
    kernels = sum(1 for e in events if e.get('cat') == 'kernel')
    scalars = [n for n in os.listdir(os.path.join(work, 'log'))
               if n.startswith('events.out.tfevents')]
    print(f"  profile_steps [0, 1]: {len(events)} trace events, {kernels} "
          f"CUDA kernels; tensorboard scalars "
          f"{'written' if scalars else 'not written (no writer imports)'}",
          flush=True)
    if kernels == 0:
        raise AssertionError("the profile_steps trace holds no CUDA kernel")
    return best


def recipe_eval(card, work, data):
    """Recipe phase, step 3: ``python -m ppasr_tpu_torch.eval`` on the
    committed flagship over all eleven utterances, once per run of
    ``rf.EVAL_RUNS``; texts equal the fixture's JAX texts, beam and
    rescoring scores within BEAM_SCORE_TOL, the loss within rf.LOSS_RTOL."""
    manifest = rf.write_eval_manifest(work)
    for run, (decoder, streaming) in rf.EVAL_RUNS.items():
        (trainer, err, loss), wall = timed(lambda: eval_cli.main([
            '--configs', rf.FLAGSHIP_CONFIG, '--resume_model', rf.FLAGSHIP,
            '--streaming_eval', str(streaming), '--overwrites',
            rf.eval_overwrites(manifest) + f',decoder={decoder}']))
        texts = [r['text'] for r in trainer.eval_results]
        scores = np.array([r['score'] for r in trainer.eval_results])
        d = float(np.max(np.abs(scores - data[f'eval_{run}_scores']))) \
            if decoder != 'ctc_greedy' else 0.0
        want_loss = float(data[f'eval_{run}_loss'])
        print(f"  eval {run}: cer {err:.5f} (JAX "
              f"{float(data[f'eval_{run}_error']):.5f}), loss {loss:.5f} "
              f"(JAX {want_loss:.5f}), max |Δscore| {d:.3g}, wall "
              f"{wall:.2f} s (model load included)", flush=True)
        expect(f'eval {run}', texts, data, f'eval_{run}')
        if d > fx.BEAM_SCORE_TOL or \
                abs(loss - want_loss) > rf.LOSS_RTOL * abs(want_loss):
            raise AssertionError(f"eval {run}: scores or loss differ")


def recipe_export(card, work, overwrites, best):
    """Recipe phase, step 4: ``python -m ppasr_tpu_torch.export_model``
    of step 2's checkpoint, served by ``PPASRPredictor``: on the host
    frontend ``predict_batch`` gives the trained model's greedy
    ``evaluate`` texts on the test split; on the device frontend
    ``predict_batch`` (one B1 launch) and ``predict_stream`` (one per
    window) run, and the CTC log-probs of B1's features are within 1e-3
    of the host features'. Returns B1's launches."""
    infer = export_cli.main(['--configs', rf.STOCK_CONFIG, '--save_model_path',
                             os.path.join(work, 'models'), '--resume_model',
                             best, '--overwrites', overwrites])
    trainer, _, _ = eval_cli.main([
        '--configs', rf.STOCK_CONFIG, '--resume_model', best,
        '--overwrites', overwrites + ',decoder=ctc_greedy'])
    want = [r['text'] for r in trainer.eval_results]
    with open(os.path.join(work, 'manifest.test'), encoding='utf-8') as f:
        wavs = [json.loads(line)['audio_filepath'] for line in f]
    host = PPASRPredictor(model_path=infer, use_gpu=True)
    got = [r['text'] for r in host.predict_batch(wavs)]
    if got != want:
        raise AssertionError(f"exported model's host-frontend texts {got} "
                             f"!= the trained model's evaluate {want}")
    pred = PPASRPredictor(model_path=infer, use_gpu=True,
                          use_device_frontend=True)
    pcms = [AudioSegment.from_file(w).to('int16') for w in wavs]
    before = fbank_cuda.launches
    batch, batch_s = timed(lambda: pred.predict_batch(wavs))
    stream, stream_s = timed(lambda: fx.stream_text(pred, pcms[0]))
    launches = fbank_cuda.launches - before
    windows = stream_windows(pred, pcms[:1])
    x, lens = fx.host_features(host, pcms)
    wav, wlens = pred._waveform_batch(wavs)
    with torch.inference_mode(), ieee_float32():
        want_lp, want_n = host.model.get_ctc_log_probs(
            torch.from_numpy(x).to(host.device),
            torch.from_numpy(lens).to(host.device))
        feat, flens = fbank_cuda.fbank_batch(
            torch.from_numpy(wav).to(pred.device),
            torch.from_numpy(wlens).to(pred.device))
        got_lp, got_n = pred.model.get_ctc_log_probs(feat, flens)
    err = max(float((got_lp[i, :int(n)] - want_lp[i, :int(n)]).abs().max())
              for i, n in enumerate(want_n.tolist()))
    print(f"  exported {infer}: host-frontend predict_batch {got} equals "
          f"evaluate; device frontend predict_batch "
          f"{[r['text'] for r in batch]} in {batch_s * 1e3:.1f} ms, predict_stream {stream!r} in "
          f"{stream_s * 1e3:.1f} ms over {windows} windows; CTC log-probs "
          f"of B1's features max |Δ| {err:.3g} against the host features' "
          f"(tolerance 1e-3); fbank launches {launches}", flush=True)
    if err > 1e-3 or not torch.equal(got_n[:len(wavs)].cpu(), want_n.cpu()) \
            or launches != windows + 1:
        raise AssertionError("the exported model's device frontend is off")
    return launches


def recipe_path(card, dev):
    """Phase 14: the stock recipe through the CLIs on the card
    (``recipe_data``, ``recipe_train``, ``recipe_eval``,
    ``recipe_export``) in a workspace under build/. Returns B1's
    launches."""
    data = np.load(rf.OUT)
    work = tempfile.mkdtemp(prefix='recipe_', dir=BUILD)
    try:
        t0 = time.time()
        overwrites = recipe_data(card, work, data)
        print(f"  data: {time.time() - t0:.2f} s", flush=True)
        t0 = time.time()
        best = recipe_train(card, work, overwrites)
        print(f"  train: {time.time() - t0:.2f} s", flush=True)
        t0 = time.time()
        recipe_eval(card, work, data)
        print(f"  eval: {time.time() - t0:.2f} s", flush=True)
        t0 = time.time()
        launches = recipe_export(card, work, overwrites, best)
        print(f"  export and serve: {time.time() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# -------------------------------------------------------------------- ddp

def ddp_argv(work, name, conf, augment=''):
    """The train CLI's arguments for ``conf`` written under ``work``."""
    return ['--configs', dw.write_config(os.path.join(work, f'{name}.yml'),
                                         conf),
            '--augment_conf_path', augment,
            '--save_model_path', os.path.join(work, name, 'models'),
            '--log_dir', os.path.join(work, name, 'log')]


def ddp_last_model(work, name, model_dir):
    return convert_params(load_msgpack(os.path.join(
        work, name, 'models', model_dir, 'last_model', 'model.msgpack')))


def ddp_start(conf):
    """The trainer's initial parameters for ``conf`` (seeded) on the CPU."""
    trainer = PPASRTrainer(conf, use_gpu=False)
    model = trainer._build_model(
        80, trainer._build_dataset(train=False).vocab_size)
    trainer._init_params(model)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def ddp_nccl(work):
    """Ddp phase, (a): the flagship as committed (256 × 12 blocks, bf16 AMP,
    dropout, the device frontend with dither, SpecAugment and SpecSub,
    configs/augmentation.json's audio stages on the native loader),
    batches of 4 × accum_grad 2 over the 16 utterances of
    ``dw.write_corpus``: 2 updates under ``torch.distributed.run
    --nproc_per_node=1`` (one NCCL rank on cuda:0, DDP and its all-reduce)
    and the same without torchrun's environment, both after
    ``random.seed(0)``; the losses must be bit-equal, B1 launched once per
    micro-batch in each. Returns B1's launches."""
    conf = dw.config(work, tiny=False, dropout=True,
                     dataset_conf={'batch_size': 4},
                     train_conf={'enable_amp': True, 'accum_grad': 2,
                                 'device_frontend': True})
    runs = {}
    for name, nproc in (('alone', None), ('torchrun', 1)):
        (report,), wall = timed(lambda: dw.launch(
            os.path.join(work, f'{name}_report'),
            ddp_argv(work, name, conf, dw.AUGMENTATION), nproc=nproc,
            cwd=work, timeout=600)[0])
        runs[name] = report
        print(f"  (a) {name}: {wall:.2f} s for the process, losses "
              f"{report['losses']}, backend {report['backend']}, "
              f"{report['device']}, B1 launches {report['launches']}, "
              f"native batches {report['native_batches']}", flush=True)
    alone, ranked = runs['alone'], runs['torchrun']
    if not (ranked['ddp'] and ranked['backend'] == 'nccl'
            and ranked['world'] == 1 and not alone['ddp']):
        raise AssertionError(f"(a) ran {ranked} / {alone}")
    if ranked['losses'] != alone['losses'] or len(alone['losses']) != 2 \
            or not np.isfinite(alone['losses']).all():
        raise AssertionError(f"(a) losses under one NCCL rank "
                             f"{ranked['losses']} != alone {alone['losses']}")
    for r in (alone, ranked):
        if r['launches'] != 4 or r['native_batches'] != 2:
            raise AssertionError(f"(a) B1 launches {r['launches']} (want "
                                 f"4, one per micro-batch), native batches "
                                 f"{r['native_batches']}")
    return alone['launches'] + ranked['launches']


def ddp_gloo(work):
    """Ddp phase, (b): two gloo ranks both on cuda:0 under
    ``torch.distributed.run --nproc_per_node=2`` (more ranks than cards:
    gloo) against one process with the same global batch (8: 2 × accum_grad
    2 a rank), the narrow model of the CPU tests in float32, not streaming
    (the dynamic chunk's draw depends on the padded length), dropout and
    dither off, ``dw.PARITY_OPTIMIZER``, raw audio on the native loader
    through B1: losses and gradient norms within 1e-5 relative, last_model
    within 1e-5 and moved from the start by over 100 times that, the
    ranks' parameters bit-equal, only rank 0 writing checkpoints. Returns
    B1's launches."""
    reports = {}
    for name, nproc, batch in (('one', None, 4), ('two', 2, 2)):
        conf = dw.config(work, streaming=False,
                         dataset_conf={'batch_size': batch},
                         train_conf={'accum_grad': 2,
                                     'device_frontend': True},
                         optimizer_conf=dw.PARITY_OPTIMIZER)
        argv = ddp_argv(work, f'gloo_{name}', conf)
        reports[name], wall = timed(lambda: dw.launch(
            os.path.join(work, f'gloo_{name}_report'), argv, nproc=nproc,
            cwd=work, dither=False, timeout=600)[0])
        print(f"  (b) {name} process(es): {wall:.2f} s, losses "
              f"{[r['losses'] for r in reports[name]]}, devices "
              f"{[r['device'] for r in reports[name]]}", flush=True)
    (one,), two = reports['one'], reports['two']

    def rel(key):
        return max(abs(a - b) / abs(b) for a, b in zip(two[0][key],
                                                       one[key]))
    model_dir = 'conformer_fbank'
    want = ddp_last_model(work, 'gloo_one', model_dir)
    got = ddp_last_model(work, 'gloo_two', model_dir)
    err = max(float((got[k] - v).abs().max()) for k, v in want.items())
    start = ddp_start(conf)
    moved = max(float((want[k] - v).abs().max()) for k, v in start.items())
    print(f"  (b) two gloo ranks against one process: losses within "
          f"{rel('losses'):.3g}, gradient norms {two[0]['grad_norms']} "
          f"within {rel('grad_norms'):.3g} relative (tolerance 1e-5), "
          f"last_model within {err:.3g} (tolerance 1e-5) after moving "
          f"{moved:.3g} from the start, rank digests equal "
          f"{two[0]['digest'] == two[1]['digest']}, checkpoints written "
          f"{[r['saves'] for r in two]}", flush=True)
    if not (all(r['backend'] == 'gloo' and r['device'] == 'cuda:0'
                and r['world'] == 2 for r in two)
            and two[0]['losses'] == two[1]['losses']
            and two[0]['grad_norms'] == two[1]['grad_norms']
            and two[0]['digest'] == two[1]['digest']
            and rel('losses') <= 1e-5 and rel('grad_norms') <= 1e-5
            and err <= 1e-5 and moved > 100 * 1e-5
            and two[1]['saves'] == []
            and two[0]['saves'] == ['epoch_1', 'best_model']):
        raise AssertionError("(b) two gloo ranks disagree with one process")
    return one['launches'] + sum(r['launches'] for r in two)


def ddp_native(card, work):
    """Ddp phase, (c): the native loader built here (g++, csrc/
    audio_pipeline.cpp) on the recipe phase's eleven utterances against
    the Python item path under the same decisions, transform by
    transform, within ``nu.TOLERANCES``."""
    entries = []
    for i, (pcm, text, _) in enumerate(rf.utterances()):
        path = os.path.join(work, f'native_{i}.wav')
        AudioSegment.from_ndarray(pcm).to_wav_file(path)
        entries.append({'audio_filepath': path, 'duration': len(pcm) / 16e3,
                        'text': text})
    noise = nu.write_noise(os.path.join(work, 'noise.wav'))
    errors, wall = timed(lambda: nu.native_against_items(entries, noise,
                                                         n_threads=4))
    print(f"  (c) native loader ({native_pipeline.library_path().name}) "
          f"against the Python item path, max |Δ| in int16 units: "
          f"{errors} (tolerances {nu.TOLERANCES}); {wall:.3f} s", flush=True)
    bad = {k: v for k, v in errors.items() if v > nu.TOLERANCES[k]}
    if bad:
        raise AssertionError(f"(c) the native loader is off: {bad}")


def ddp_path(card):
    """Phase 15: multi-process training (``ddp_nccl``, ``ddp_gloo``,
    ``ddp_native``) in a workspace under build/. Returns B1's launches."""
    work = tempfile.mkdtemp(prefix='ddp_', dir=BUILD)
    try:
        dw.write_corpus(work)
        t0 = time.time()
        launches = ddp_nccl(work)
        print(f"  (a): {time.time() - t0:.2f} s", flush=True)
        t0 = time.time()
        launches += ddp_gloo(work)
        print(f"  (b): {time.time() - t0:.2f} s", flush=True)
        t0 = time.time()
        ddp_native(card, work)
        print(f"  (c): {time.time() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"  B1 launches in the ranks' processes: {launches}", flush=True)
    return launches


# --------------------------------------------------------------------- tp

def tp_grid(card, work, n_data, n_model, one, one_whole):
    """Tp phase, one grid: the ranks' reports against the process alone
    (``one``, ``one_whole``). Returns the ranks' reports."""
    name = f'flagship_{n_data}x{n_model}'
    reps = tw.reports(work, name)
    whole = np.load(os.path.join(work, f'{name}.rank0.params.npz'))

    def rel(key):
        return max(abs(a - b) / abs(b) for a, b in zip(reps[0][key],
                                                       one[key]))
    err = max(float(np.abs(whole[k] - v.numpy()).max())
              for k, v in one_whole.items())
    groups = {}
    for r in reps:
        groups.setdefault(r['data_index'], set()).add(r['replicated'])
    print(f"  DP{n_data}xTP{n_model}: losses {reps[0]['losses']} within "
          f"{rel('losses'):.3g}, gradient norms {reps[0]['grad_norms']} "
          f"within {rel('grad_norms'):.3g} relative of the process alone "
          f"(tolerance 1e-5); whole parameters within {err:.3g} "
          f"(tolerance 1e-5); replicated parameters bit-equal across each "
          f"model group {all(len(g) == 1 for g in groups.values())}; "
          f"{reps[0]['n_sharded']} of the rank's tensors sharded; wall per "
          f"update {[round(t, 4) for t in reps[0]['walls']]} s "
          f"(gloo on one card, host clock; not NCCL between cards); "
          f"{card}", flush=True)
    if not (all(r['losses'] == reps[0]['losses']
                and r['grad_norms'] == reps[0]['grad_norms'] for r in reps)
            and rel('losses') <= 1e-5 and rel('grad_norms') <= 1e-5
            and err <= 1e-5 and set(whole.files) == set(one_whole)
            and all(len(g) == 1 for g in groups.values())
            and all(r['n_sharded'] > 0 for r in reps)):
        raise AssertionError(f"DP{n_data}xTP{n_model} disagrees with the "
                             f"process alone")
    return reps


def tp_path(card, dev):
    """Phase 16: tensor parallelism, four gloo ranks on cuda:0 under one
    ``torch.distributed.run --nproc_per_node=4`` launch of
    tests/torch_tp_worker.py (the committed flagship, float32, dropout and
    dither off, raw audio through B1): DP2×TP2 and DP1×TP4 against the
    same global batches in this process, then the DP4 beam decode of the
    flagship's posteriors against this process's decode. Returns B1's
    launches, the ranks' included."""
    work = tempfile.mkdtemp(prefix='tp_', dir=BUILD)
    grids = ((2, 2), (1, 4))
    try:
        spec = {'out': work, 'device': 'cuda:0',
                'train': [['flagship', *g] for g in grids],
                'decode': ['flagship']}
        proc = tw.start(spec)
        _, wall = timed(lambda: tw.finish(proc, timeout=600))
        print(f"  the 4 ranks' launch: {wall:.2f} s, start to exit",
              flush=True)
        launches = fbank_cuda.launches
        (one, one_whole), alone_s = timed(lambda: tw.train('flagship', dev))
        print(f"  the process alone: losses {one['losses']}, gradient "
              f"norms {one['grad_norms']}, wall per update "
              f"{[round(t, 4) for t in one['walls']]} s ({alone_s:.2f} s "
              f"with the build); {card}", flush=True)
        moved = max(float((one_whole[k] - v).abs().max()) for k, v in
                    convert_params(load_msgpack(tf.CHECKPOINT)).items())
        if not moved > 100 * 1e-5:
            raise AssertionError(f"2 updates moved the flagship by {moved}")
        reps = [r for g in grids for r in tp_grid(card, work, *g, one,
                                                  one_whole)]
        dec, probs, logits, lens = tw.decode_inputs('flagship', dev)
        want = dec.decode_batch(probs, lens)
        want_l = dec.decode_batch_from_logits(logits, lens)
        launches = fbank_cuda.launches - launches
        decoded = tw.reports(work, 'decode')
        got, got_l = (decoded[0]['flagship'][k]
                      for k in ('results', 'from_logits'))
        dscore = max(abs(a[0] - b[0]) for a, b in zip(got + got_l,
                                                       want + want_l))
        print(f"  DP4 beam decode (beam {dec.beam_size}, LM order "
              f"{dec.lm_hash.order}) of 8 utterances, 2 a rank: texts "
              f"equal to this process's from probabilities "
              f"{[t for _, t in got] == [t for _, t in want]} and from "
              f"logits {[t for _, t in got_l] == [t for _, t in want_l]}, "
              f"max |Δscore| {dscore:.3g}", flush=True)
        if not ([t for _, t in got] == [t for _, t in want]
                and [t for _, t in got_l] == [t for _, t in want_l]
                and all(d == decoded[0] for d in decoded)
                and all(t for _, t in want)
                and dscore <= fx.BEAM_SCORE_TOL):
            raise AssertionError("the DP4 decode differs from the process "
                                 "alone")
        ranks = sum(r['launches'] for r in reps) \
            + sum(d['launches'] for d in decoded)
        want_ranks = 4 * 2 * tw.UPDATES * tw.ACCUM + 4
        print(f"  B1 launches: {ranks} in the ranks (one per micro-batch "
              f"and rank, one per decoding rank), {launches} here",
              flush=True)
        if ranks != want_ranks or launches != tw.UPDATES * tw.ACCUM + 1:
            raise AssertionError(f"B1 launched {ranks} times in the ranks "
                                 f"(want {want_ranks}) and {launches} here")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ranks + launches


# ----------------------------------------------------------------- deploy

def pt2_sizes(directory):
    return {f: os.path.getsize(os.path.join(directory, f))
            for f in sorted(os.listdir(directory)) if f.endswith('.pt2')}


def deploy_int8(card, ddata, pcms):
    """Deploy phase, int8: the committed flagship quantized by the port,
    its dequantized weights bit-equal to the JAX package's (the fixture's
    digest), served alone from ``model_quant.msgpack`` on the device
    frontend; texts equal JAX's from its own int8 file. Returns B1's
    launches (one per streamed window)."""
    tree = load_msgpack(dfx.FLAGSHIP)
    blob, q_s = timed(lambda: quantize_params(tree))
    digest = dfx.quant_digest(dequantize_params(blob))
    if digest != str(ddata['jax_quant_digest']):
        raise AssertionError(f"dequantized flagship {digest} is not the "
                             f"JAX package's {ddata['jax_quant_digest']}")
    qdir = dfx.quant_artifact(os.path.join(BUILD, 'deploy_int8'),
                              lambda p: save_msgpack(p, blob))
    full = os.path.getsize(dfx.FLAGSHIP)
    small = os.path.getsize(os.path.join(qdir, 'model_quant.msgpack'))
    pred, build_s = timed(lambda: PPASRPredictor(
        model_path=qdir, use_gpu=True, use_device_frontend=True))
    before = fbank_cuda.launches
    offline, off_s = timed(lambda: [pred.predict(p)['text'] for p in pcms])
    stream, stream_s = timed(lambda: [fx.stream_text(pred, p)
                                      for p in pcms])
    launches = fbank_cuda.launches - before
    windows = stream_windows(pred, pcms)
    print(f"  int8: quantized in {q_s:.2f} s, dequantized weights equal "
          f"JAX's (sha256 {digest[:16]}); model.msgpack {full} B, "
          f"model_quant.msgpack {small} B ({full / small:.3f}x smaller); "
          f"predictor from the int8 file alone built in {build_s:.2f} s",
          flush=True)
    print(f"  on {card}: int8 predict {offline} ({off_s / 3 * 1e3:.1f} ms "
          f"per utterance), predict_stream {stream} "
          f"({stream_s / windows * 1e3:.2f} ms per window over {windows} "
          f"windows); fbank launches {launches}", flush=True)
    expect('int8 predict', offline, ddata, 'jax_quant_offline')
    expect('int8 predict_stream', stream, ddata, 'jax_quant_stream')
    if launches != windows:
        raise AssertionError(f"int8 stream: {launches} fbank launches for "
                             f"{windows} windows")
    return launches


def program_texts(infer, feats, vocab):
    """(offline texts, 67-frame chunk texts, [offline posteriors], [chunk
    posteriors], offline seconds, chunk seconds, chunks) of an
    ``InferencePredictor`` on host features."""
    offline, chunks, off_p, chunk_p = [], [], [], []
    off_s = chunk_s = 0.0
    n_chunks = 0
    for feat in feats:
        (probs, olens), s = timed(lambda: infer.predict(
            feat[None], np.array([feat.shape[0]])))
        off_s += s
        off_p.append(probs[0, :int(olens[0])])
        offline.append(greedy_module.greedy_decoder(off_p[-1], vocab)[1])
        infer.reset_stream()
        windows = dfx.chunk_windows(feat)
        posts, s = timed(lambda: [infer.predict_chunk_conformer(w)[0]
                                  for w in windows])
        chunk_s += s
        n_chunks += len(windows)
        chunk_p.append(np.concatenate(posts))
        chunks.append(greedy_module.greedy_decoder(chunk_p[-1], vocab)[1])
    return offline, chunks, off_p, chunk_p, off_s, chunk_s, n_chunks


def deploy_programs(card, ddata, pred, pcms):
    """Deploy phase, programs: ``PPASRTrainer.export(save_stablehlo=True)``
    of the flagship at full width on the card, served by
    ``InferencePredictor`` with no model code on the utterances' host
    features, offline and in 67-frame chunks: posteriors within
    ``dfx.PROGRAM_TOL`` of the model code on the card (TF32 off) and
    greedy texts equal to the fixture's JAX ones; then the other three
    families' programs from the zoo fixture's seeds, each against its
    model code."""
    trainer = PPASRTrainer(os.path.join(ROOT, 'configs', 'campaign',
                                        'conformer_synth.yml'), use_gpu=True)
    infer, export_s = timed(lambda: trainer.export(
        save_model_path=os.path.join(BUILD, 'deploy_models'),
        resume_model=os.path.dirname(dfx.FLAGSHIP), save_stablehlo=True))
    sizes = pt2_sizes(infer)
    prog, load_s = timed(lambda: InferencePredictor(infer, use_gpu=True))
    code = InferencePredictor(infer, os.path.join(infer, 'mean_istd.json'),
                              use_gpu=True, use_stablehlo=False)
    if not (prog.stablehlo and prog.model is None and not code.stablehlo):
        raise AssertionError("the exported programs were not served")
    feats = [pred.audio_featurizer.featurize(pred._load_audio(p))
             for p in pcms]
    got = program_texts(prog, feats, pred.vocab_list)
    want = program_texts(code, feats, pred.vocab_list)
    err_off, err_chunk = (max(float(np.abs(a - b).max())
                              for a, b in zip(got[i], want[i]))
                          for i in (2, 3))
    err = max(err_off, err_chunk)
    # the program pads T to its 16-frame grid, the model code does not:
    # held again with the model code given the same padded input
    err_same = 0.0
    for f in feats:
        t = max(32, -(-len(f) // 16) * 16)
        fp = np.pad(f, ((0, t - len(f)), (0, 0)))[None]
        (p1, l1), (p2, _) = (p.predict(fp, np.array([len(f)]))
                             for p in (prog, code))
        err_same = max(err_same,
                       float(np.abs(p1[0, :l1[0]] - p2[0, :l1[0]]).max()))
    print(f"  programs: flagship exported in {export_s:.2f} s (CPU and card "
          f"programs, with model.msgpack), sizes {sizes} B; served in "
          f"{load_s:.2f} s with no model code", flush=True)
    print(f"  on {card}: program texts offline {got[0]}, chunks {got[1]}; "
          f"max |Δ posterior| against the model code {err:.3g} (tolerance "
          f"{dfx.PROGRAM_TOL}; offline {err_off:.3g}, chunks "
          f"{err_chunk:.3g}; offline at the program's padded length "
          f"{err_same:.3g}); wall per utterance offline "
          f"{got[4] / 3 * 1e3:.2f} ms (model code {want[4] / 3 * 1e3:.2f}), "
          f"per chunk {got[5] / got[6] * 1e3:.3f} ms (model code "
          f"{want[5] / want[6] * 1e3:.3f}) over {got[6]} chunks",
          flush=True)
    expect('program offline', got[0], ddata, 'jax_program_offline')
    expect('program chunks', got[1], ddata, 'jax_program_chunks')
    if not err <= dfx.PROGRAM_TOL:
        raise AssertionError(f"program posteriors differ from the model "
                             f"code by {err}")
    del prog, code
    rng = np.random.default_rng(0)
    for use_model in zf.FAMILIES:
        art = os.path.join(BUILD, f'zoo_{use_model}')
        if not os.path.exists(os.path.join(art, 'inference.json')):
            zf.zoo_artifact(use_model, art)
        code = InferencePredictor(art, os.path.join(art, 'mean_istd.json'),
                                  use_gpu=True, use_stablehlo=False)
        _, export_s = timed(lambda: export_programs(
            code.model, art, use_model, code.input_dim, devices=('cuda',)))
        prog = InferencePredictor(art, use_gpu=True)
        x = (0.5 * rng.standard_normal((2, 400, code.input_dim))).astype(
            np.float32)
        lens = np.array([400, 333])
        (p1, l1), s1 = timed(lambda: prog.predict(x, lens))
        (p2, l2), s2 = timed(lambda: code.predict(x, lens))
        w = x[:1, :67]
        ds2 = use_model == 'deepspeech2'
        step = (lambda p: p.predict_chunk_deepspeech(w)) if ds2 else \
            (lambda p: p.predict_chunk_conformer(w))
        c1, c2 = step(prog), step(code)
        err = max(float(np.abs(p1[i, :n] - p2[i, :n]).max())
                  for i, n in enumerate(l1))
        err = max(err, float(np.abs(c1 - c2).max()))
        print(f"  {use_model}: exported in {export_s:.2f} s, sizes "
              f"{pt2_sizes(art)} B; max |Δ posterior| against the model "
              f"code {err:.3g}; offline batch of 2 × 400 frames "
              f"{s1 * 1e3:.2f} ms (model code {s2 * 1e3:.2f} ms)",
              flush=True)
        if not (prog.stablehlo and np.array_equal(l1, l2)
                and err <= dfx.PROGRAM_TOL):
            raise AssertionError(f"{use_model} programs differ from the "
                                 f"model code by {err}")


def wav_bytes(pcm):
    buf = io.BytesIO()
    with wave.open(buf, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.asarray(pcm).astype('<i2').tobytes())
    return buf.getvalue()


def http(port, method, path, body=None):
    conn = http_client.HTTPConnection('127.0.0.1', port, timeout=300)
    conn.request(method, path, body=body,
                 headers={'Content-Type': 'audio/wav'} if body else {})
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out


def ws_messages(pcm, piece):
    return [pcm[i:i + piece].astype('<i2').tobytes()
            for i in range(0, len(pcm), piece)] + [b'end']


async def ws_client(port, messages):
    """A real WebSocket client: each message sent, its answer read; →
    (the answers, seconds per message)."""
    import websockets
    answers = []
    async with websockets.connect(f'ws://127.0.0.1:{port}',
                                  max_size=None) as ws:
        t0 = time.time()
        for m in messages:
            await ws.send(m)
            answers.append(json.loads(await ws.recv()))
        return answers, (time.time() - t0) / len(messages)


def deploy_server(card, data, artifact, pcms):
    """Deploy phase, server: ``infer_server.main`` in this process on free
    localhost ports with the flagship, ``use_gpu`` and the device frontend:
    ``POST /recognition`` per utterance and ``/recognition_long_audio`` on
    the long recording give the JAX ``predict`` / ``predict_long`` texts,
    ``GET /`` the client page, three concurrent WebSocket streams in 0.16 s
    pieces through ``websockets`` clients the JAX engine texts. Returns
    B1's launches
    (the long recording's batch: the engine featurizes on the host, as the
    JAX engine does)."""
    piece = int(data['piece'])
    server = infer_server.main(
        ['--configs', os.path.join(ROOT, 'configs', 'campaign',
                                   'conformer_synth.yml'),
         '--model_path', artifact, '--decoder', 'ctc_greedy',
         '--use_gpu', 'True', '--use_device_frontend', 'True',
         '--host', '127.0.0.1', '--port', '0', '--ws_port', '0',
         '--max_streams', '4',
         '--save_audio_dir', os.path.join(BUILD, 'deploy_uploads')],
        block=False)
    try:
        before = fbank_cuda.launches
        port = server.http_port
        texts, walls = [], []
        for pcm in pcms:
            (status, body), s = timed(lambda: http(port, 'POST',
                                                   '/recognition',
                                                   wav_bytes(pcm)))
            reply = json.loads(body)
            if status != 200 or reply['code'] != 0:
                raise AssertionError(f"/recognition answered {status} "
                                     f"{reply}")
            texts.append(reply['result'])
            walls.append(s)
        (status, body), long_s = timed(lambda: http(
            port, 'POST', '/recognition_long_audio',
            wav_bytes(fx.long_recording(pcms))))
        long_text = json.loads(body)['result']
        status_get, page = http(port, 'GET', '/')
        with open(os.path.join(ROOT, 'templates', 'index.html'), 'rb') as f:
            page_ok = status_get == 200 and page == f.read()
        messages = [ws_messages(p, piece) for p in pcms]
        t0 = time.time()

        async def clients():
            return await asyncio.gather(*[
                ws_client(server.ws_port, m) for m in messages])
        runs = asyncio.run(clients())
        answers = [a for a, _ in runs]
        per_msg = [s for _, s in runs]
        ws_s = time.time() - t0
        launches = fbank_cuda.launches - before
        ws_texts = [a[-1]['result'] for a in answers]
    finally:
        server.stop()
    n_windows = sum(len(m) - 1 for m in messages)
    print(f"  on {card}: /recognition {texts}, "
          f"{statistics.mean(walls) * 1e3:.1f} ms per request; "
          f"/recognition_long_audio {long_text!r} in {long_s * 1e3:.1f} ms; "
          f"GET / serves index.html {page_ok}; WebSocket {ws_texts}, "
          f"3 concurrent streams of {n_windows} pieces of 0.16 s in "
          f"{ws_s:.3f} s, {ws_s / n_windows * 1e3:.2f} ms per piece "
          f"(per stream {per_msg}); fbank launches {launches}", flush=True)
    expect('server /recognition', texts, data, 'jax_offline')
    expect('server WebSocket', ws_texts, data, 'jax_engine')
    if long_text != str(data['jax_long']) or not page_ok:
        raise AssertionError(f"server long audio {long_text!r} != "
                             f"{data['jax_long']} or GET / failed")
    if any(a['code'] != 0 for run in answers for a in run):
        raise AssertionError("a WebSocket answer had a code other than 0")
    if launches != 1:
        raise AssertionError(f"{launches} fbank launches for the long "
                             f"recording's one batch")
    return launches


def deploy_vad(card, ddata):
    """Deploy phase, ``VADModel``: the fixture's seeded weights on the
    card, two stateful calls, probabilities within ``dfx.VAD_TOL`` of the
    JAX package's."""
    vdir = dfx.write_vad_model(os.path.join(BUILD, 'deploy_vad'),
                               save_msgpack, int(ddata['vad_seed']))
    model = VADModel(vdir, device='cuda:0')
    first, second = dfx.vad_windows(int(ddata['vad_windows_seed']))
    probs, s = timed(lambda: np.concatenate([model(first), model(second)]))
    err = float(np.abs(probs - ddata['jax_vad_probs']).max())
    on_card = all(p.is_cuda for p in model.net.parameters())
    print(f"  on {card}: VADModel on the card {on_card}, {len(probs)} "
          f"windows in {s * 1e3:.2f} ms, max |Δ probability| against JAX "
          f"{err:.3g} (tolerance {dfx.VAD_TOL})", flush=True)
    if not (on_card and err < dfx.VAD_TOL):
        raise AssertionError(f"VADModel differs from JAX's by {err}")


def deploy_path(card, pred, artifact, data, pcms):
    """Phase 17: the deployment path (``deploy_int8``,
    ``deploy_programs``, ``deploy_server``, ``deploy_vad``). Returns B1's
    launches."""
    ddata = np.load(dfx.OUT)
    t0 = time.time()
    launches = deploy_int8(card, ddata, pcms)
    print(f"  int8: {time.time() - t0:.2f} s", flush=True)
    t0 = time.time()
    deploy_programs(card, ddata, pred, pcms)
    print(f"  programs: {time.time() - t0:.2f} s", flush=True)
    t0 = time.time()
    launches += deploy_server(card, data, artifact, pcms)
    print(f"  server: {time.time() - t0:.2f} s", flush=True)
    t0 = time.time()
    deploy_vad(card, ddata)
    print(f"  VADModel: {time.time() - t0:.2f} s", flush=True)
    return launches


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
    launches += train_path(card, dev)
    train_timing(card, dev)
    phase('train', t0)

    t0 = time.time()
    launches += zoo_path(card, dev)
    phase('zoo', t0)

    t0 = time.time()
    launches += recipe_path(card, dev)
    phase('recipe', t0)

    t0 = time.time()
    launches += ddp_path(card)
    phase('ddp', t0)

    t0 = time.time()
    launches += tp_path(card, dev)
    phase('tp', t0)

    t0 = time.time()
    launches += deploy_path(card, pred, artifact, data, pcms)
    phase('deploy', t0)

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
