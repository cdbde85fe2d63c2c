"""Kernel B1, the fused fbank: build, bind and launch ``csrc/fbank.cu``.

Replaces ppasr_tpu/ops/fbank_pallas.py ``_fbank_kernel`` (launched by
``fbank_frames_pallas``, :90-131). The kernel computes each frame's 512-point
real DFT as a packed 256-point complex FFT (radix 8, 8, 4) with a split step,
one warp per frame and eight frames a block, in float32 on the CUDA cores;
it projects the power onto the mel filters over each filter's own band of
bins, from the compact tables that ``_constants`` builds (``mel_bands``).
The CUDA source is compiled at first use with plain ``nvcc`` for ``sm_90a``
into a shared library with a C interface (``ops/cuda_build.py``) and
loaded with ``ctypes``.

The wrappers take a CPU tensor to the plain version (``ops/fbank.py``) and a
CUDA tensor to the kernel; on a CUDA tensor they launch the kernel or raise.
``launches`` counts kernel launches and nothing else.
"""
import ctypes
from pathlib import Path

import numpy as np
import torch

from ppasr_tpu_torch.ops import cuda_build
from ppasr_tpu_torch.ops.fbank import (batch_frame_lens, fbank_batch_torch,
                                       fbank_frames_torch, frame_torch,
                                       get_mel_banks, povey_window)

WINDOW_SIZE = 400    # the kernel's frame length: 25 ms at 16 kHz
WINDOW_SHIFT = 160   # 10 ms at 16 kHz
N_FFT = 512
N_BINS = 256         # bins the kernel computes; bin 256 has zero mel weight
MAX_MELS = 256       # the kernel's band tables hold at most 256 filters
MAX_WEIGHTS = 512    # packed mel weights the kernel holds in shared memory

SOURCE = Path(__file__).resolve().parent.parent / 'csrc' / 'fbank.cu'

launches = 0
_lib = None
_consts = {}


def build(force: bool = False) -> Path:
    return cuda_build.build(SOURCE, 'fbank', force)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fbank_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.fbank_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def mel_bands(mel: np.ndarray):
    """Compact tables of mel weights ``[M, bins]`` whose every row is zero
    outside one contiguous run of bins: ``band`` int32 [M, 3] holds each
    filter's first bin, length (0 for an empty filter) and offset into
    ``weights``, the rows' runs packed in order."""
    band = np.zeros((mel.shape[0], 3), np.int32)
    runs = []
    off = 0
    for m, row in enumerate(mel):
        nz = np.flatnonzero(row)
        if nz.size:
            first, length = int(nz[0]), int(nz[-1]) + 1 - int(nz[0])
            runs.append(row[first:first + length])
            band[m] = first, length, off
            off += length
        else:
            band[m] = 0, 0, off
    return band, np.concatenate(runs or [np.zeros(0, np.float32)])


def _constants(device, num_mel_bins, sample_rate, low_freq, high_freq):
    """Povey window [400], mel band table [M, 3] int32 and packed mel
    weights on ``device``."""
    key = (str(device), num_mel_bins, sample_rate, low_freq, high_freq)
    if key not in _consts:
        mel = get_mel_banks(num_mel_bins, N_FFT, float(sample_rate), low_freq,
                            high_freq)
        if np.any(mel[:, N_BINS:]):
            raise ValueError("mel weights above bin 255 are not zero")
        band, weights = mel_bands(mel[:, :N_BINS])
        if weights.size > MAX_WEIGHTS:
            raise ValueError(f"{weights.size} mel weights, the kernel holds "
                             f"{MAX_WEIGHTS}")
        _consts[key] = tuple(torch.from_numpy(a).to(device) for a in (
            povey_window(WINDOW_SIZE), band, weights))
    return _consts[key]


def fbank_strided(wav: torch.Tensor, n_frames: int, frame_stride: int,
                  num_mel_bins: int = 80, sample_rate: int = 16000,
                  preemphasis: float = 0.97, remove_dc_offset: bool = True,
                  low_freq: float = 20.0, high_freq: float = 0.0,
                  out_rows: int = None, noise: torch.Tensor = None,
                  noise_group: int = None):
    """Launch the kernel: frame f is ``wav.view(-1)[f*frame_stride:][:400]``
    for f < n_frames. ``wav`` is a contiguous float32 CUDA tensor holding
    every sample the frames read. Returns [out_rows, num_mel_bins] float32
    (``out_rows`` defaults to ``n_frames``) whose first n_frames rows the
    kernel wrote; the rest are left unwritten.

    ``noise`` (training dither): a contiguous float32 [G, R, 400] tensor on
    the same device; frame t of each group of ``noise_group`` frames (all
    n_frames by default) adds row [g, t] to its samples before the DC
    removal, and frames with t >= R add nothing."""
    global launches
    if wav.device.type != 'cuda':
        raise ValueError(f"fbank kernel needs a CUDA tensor, got {wav.device}")
    if wav.dtype != torch.float32:
        raise TypeError(f"fbank kernel needs float32, got {wav.dtype}")
    if not wav.is_contiguous():
        raise ValueError("fbank kernel needs a contiguous tensor")
    if sample_rate != 16000:
        raise ValueError("the fbank kernel is built for 16 kHz frames of 400 "
                         f"samples, got sample_rate={sample_rate}")
    if not 0 < num_mel_bins <= MAX_MELS:
        raise ValueError(f"num_mel_bins must be in 1..{MAX_MELS}")
    if n_frames < 0 or frame_stride < 1:
        raise ValueError(f"bad n_frames={n_frames} / stride={frame_stride}")
    if n_frames and (n_frames - 1) * frame_stride + WINDOW_SIZE > wav.numel():
        raise ValueError(f"{n_frames} frames at stride {frame_stride} need "
                         f"{(n_frames - 1) * frame_stride + WINDOW_SIZE} "
                         f"samples, got {wav.numel()}")
    out_rows = n_frames if out_rows is None else out_rows
    if out_rows < n_frames:
        raise ValueError(f"out_rows={out_rows} < n_frames={n_frames}")
    noise_ptr, noise_rows = None, 0
    if noise is not None:
        noise_group = n_frames if noise_group is None else noise_group
        if (noise.device != wav.device or noise.dtype != torch.float32
                or not noise.is_contiguous() or noise.ndim != 3
                or noise.shape[2] != WINDOW_SIZE):
            raise ValueError(f"noise must be a contiguous float32 [G, R, "
                             f"{WINDOW_SIZE}] tensor on {wav.device}, got "
                             f"{noise.dtype} {tuple(noise.shape)} on "
                             f"{noise.device}")
        noise_rows = noise.shape[1]
        groups = -(-n_frames // max(noise_group, 1))
        if noise_group < 1 or noise_rows > noise_group or \
                noise.shape[0] < groups:
            raise ValueError(f"noise {tuple(noise.shape)} does not cover "
                             f"{n_frames} frames in groups of {noise_group}")
        noise_ptr = noise.data_ptr() if noise_rows else None
    out = torch.empty((out_rows, num_mel_bins), dtype=torch.float32,
                      device=wav.device)
    if n_frames == 0:
        return out
    window, band, weights = _constants(wav.device, num_mel_bins,
                                       sample_rate, low_freq, high_freq)
    lib = _library()
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        rc = lib.fbank_launch(wav.data_ptr(), frame_stride, n_frames,
                              window.data_ptr(), band.data_ptr(),
                              weights.data_ptr(), num_mel_bins, preemphasis,
                              int(remove_dc_offset), noise_ptr, WINDOW_SIZE,
                              noise_group or 1, noise_rows, out.data_ptr(),
                              stream)
    if rc != 0:
        raise RuntimeError(f"fbank kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def fbank_frames(frames: torch.Tensor, num_mel_bins: int = 80,
                 sample_rate: int = 16000, **kw) -> torch.Tensor:
    """[N, 400] int16-scaled frames → [N, num_mel_bins] log-mel; the
    counterpart of ``fbank_frames_pallas`` (frame stride 400)."""
    if frames.ndim != 2 or frames.shape[1] != WINDOW_SIZE:
        raise ValueError(f"frames must be [N, {WINDOW_SIZE}], "
                         f"got {tuple(frames.shape)}")
    if frames.device.type == 'cpu':
        return fbank_frames_torch(frames, sample_rate, num_mel_bins, **kw)
    return fbank_strided(frames, frames.shape[0], WINDOW_SIZE, num_mel_bins,
                         sample_rate, **kw)


def fbank_window(wav: torch.Tensor, n_frames: int, num_mel_bins: int = 80,
                 sample_rate: int = 16000, **kw) -> torch.Tensor:
    """[S] int16-scaled waveform → [n_frames, num_mel_bins] log-mel of its
    frames at stride 160: ``frame_jax`` followed by ``fbank_frames_pallas``
    (ppasr_tpu/predict.py:177-183), fused into one launch on the card."""
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {tuple(wav.shape)}")
    if wav.device.type == 'cpu':
        frames = frame_torch(wav[None], WINDOW_SIZE, WINDOW_SHIFT, n_frames)
        return fbank_frames_torch(frames[0], sample_rate, num_mel_bins, **kw)
    return fbank_strided(wav, n_frames, WINDOW_SHIFT, num_mel_bins,
                         sample_rate, **kw)


def fbank_batch(wavs: torch.Tensor, lengths: torch.Tensor,
                num_mel_bins: int = 80, sample_rate: int = 16000,
                noise: torch.Tensor = None, **kw):
    """[B, S] int16-scaled waveforms + [B] sample counts → ([B, T, M]
    log-mel, [B] int32 frame counts), T = S/160 − 2: ``fbank_jax`` as
    ``predict_batch``'s device frontend calls it (ppasr_tpu/predict.py:
    184-190), in one launch on the card. ``noise`` [B, T, 400] float32 is
    the training dither, added to each framed sample before the DC removal
    (``fbank_jax``'s ``dither · N(0, 1)`` with the draws given).

    S must be a multiple of 160. With k = S/160, frame t of row b starts at
    flat sample 160·(b·k + t), so one stride-160 launch of B·k − 2 frames
    over the contiguous [B·S] buffer computes every frame of every row. Seen
    as [B, k, M], the first k − 2 columns are row b's frames; the last two
    straddle the next row (or run past the buffer's end) and are dropped."""
    if wavs.ndim != 2:
        raise ValueError(f"wavs must be [B, S], got {tuple(wavs.shape)}")
    if wavs.device.type == 'cpu':
        return fbank_batch_torch(wavs, lengths, sample_rate, num_mel_bins,
                                 noise=noise, **kw)
    bsz, s = wavs.shape
    if not wavs.is_contiguous():
        raise ValueError("fbank_batch needs a contiguous [B, S] tensor")
    if s % WINDOW_SHIFT:
        raise ValueError(f"S={s} is not a multiple of {WINDOW_SHIFT}: the "
                         f"rows cannot share one stride-{WINDOW_SHIFT} "
                         f"launch")
    k = s // WINDOW_SHIFT
    max_t = max(k - 2, 0)
    frame_lens = batch_frame_lens(lengths.to(wavs.device), max_t)
    if noise is not None and tuple(noise.shape) != (bsz, max_t, WINDOW_SIZE):
        raise ValueError(f"noise must be [{bsz}, {max_t}, {WINDOW_SIZE}], "
                         f"got {tuple(noise.shape)}")
    out = fbank_strided(wavs.view(-1),
                        bsz * k - 2 if max_t else 0, WINDOW_SHIFT,
                        num_mel_bins, sample_rate, out_rows=bsz * k,
                        noise=noise, noise_group=k, **kw)
    return out.view(bsz, k, num_mel_bins)[:, :max_t], frame_lens
