"""The arithmetic of kernel B1 (ppasr_tpu_torch/csrc/fbank.cu), emulated in
numpy float32 on the CPU, where the CUDA kernel cannot run.

``emulate_kernel`` follows the kernel step by step: each lane's samples and
the warp's DC sum, the packing z[n] = x[2n] + i x[2n+1], the three FFT
passes (radix 8 over j, radix 8 over t1, radix 4 over t0) with their
exchanges between lanes, the twiddles indexed into the table
cos/sin(pi j / 256) exactly as the kernel indexes it, the split step, and
the banded mel projection from the tables that ``fbank_cuda._constants``
hands the kernel. It is held against the JAX package's Pallas kernel in
interpret mode and ``fbank_numpy`` at the bounds of
tests/test_fbank_pallas.py:28-29 (mean |Δ| < 1e-3, max |Δ| < 0.05
log-mel), and against the float64 plain version at max |Δ| <= 5e-4: the
direct float32 DFT that the FFT replaced read 3.4e-4 there on the card,
and an FFT, whose rounding error grows with log2 of the length and not with
the length, must be no less accurate."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppasr_tpu.ops.fbank_pallas import fbank_frames_pallas
from ppasr_tpu_torch.ops import fbank as F
from ppasr_tpu_torch.ops import fbank_cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_torch_smoke_fixture import speechlike  # noqa: E402

f32 = np.float32
H = f32(np.cos(np.pi / 4))
# the kernel's twiddle table: sincospif(j / 256) for j < 512
TW_COS = np.cos(np.pi * np.arange(512) / 256).astype(f32)
TW_SIN = np.sin(np.pi * np.arange(512) / 256).astype(f32)
LANE = np.arange(32)


def _mul_conj(re, im, j):
    c, s = TW_COS[j], TW_SIN[j]
    return re * c + im * s, im * c - re * s


def _dft4(re, im):
    c0r, c0i = re[0] + re[2], im[0] + im[2]
    c1r, c1i = re[0] - re[2], im[0] - im[2]
    c2r, c2i = re[1] + re[3], im[1] + im[3]
    c3r, c3i = im[1] - im[3], re[3] - re[1]      # (b1 - b3) * -i
    return ([c0r + c2r, c1r + c3r, c0r - c2r, c1r - c3r],
            [c0i + c2i, c1i + c3i, c0i - c2i, c1i - c3i])


def _dft8(re, im):
    ur = [re[n] + re[n + 4] for n in range(4)]
    ui = [im[n] + im[n + 4] for n in range(4)]
    vr = [re[n] - re[n + 4] for n in range(4)]
    vi = [im[n] - im[n + 4] for n in range(4)]
    vr[1], vi[1] = H * (vr[1] + vi[1]), H * (vi[1] - vr[1])
    vr[2], vi[2] = vi[2], -vr[2]
    vr[3], vi[3] = H * (vi[3] - vr[3]), -H * (vr[3] + vi[3])
    er, ei = _dft4(ur, ui)
    odd_r, odd_i = _dft4(vr, vi)
    return ([x for pair in zip(er, odd_r) for x in pair],
            [x for pair in zip(ei, odd_i) for x in pair])


def emulate_power(frames, preemph=0.97):
    """[N, 400] frames → [N, 256] float32 power spectrum, as the kernel's
    warps compute it. Arrays indexed [frame, lane] stand for one register
    of every lane."""
    x = np.asarray(frames, f32)
    n = LANE[None, :] + 32 * np.arange(7)[:, None]           # [j, t]
    valid = n < 200
    ev = np.where(valid, x[:, np.minimum(2 * n, 398)], 0).astype(f32)
    od = np.where(valid, x[:, np.minimum(2 * n + 1, 399)], 0).astype(f32)
    lane_sum = np.zeros((x.shape[0], 32), f32)
    for j in range(7):                                       # [N, j, t]
        lane_sum += ev[:, j] + od[:, j]
    for o in (16, 8, 4, 2, 1):                               # xor shuffles
        lane_sum = lane_sum + lane_sum[:, LANE ^ o]
    mean = lane_sum[:, :1] / f32(400)
    # x[2n - 1]: the odd sample of the lane to the left, or of lane 31 at
    # the previous j for lane 0; x[0] itself before the first sample
    left = od[:, :, (LANE + 31) & 31]
    prev = left.copy()
    prev[:, 1:, 0] = left[:, :-1, 0]
    prev[:, 0, 0] = ev[:, 0, 0]
    win = F.povey_window(400)
    w_ev = np.where(valid, win[np.minimum(2 * n, 398)], 0).astype(f32)
    w_od = np.where(valid, win[np.minimum(2 * n + 1, 399)], 0).astype(f32)
    e0, e1, p = ev - mean[:, :, None], od - mean[:, :, None], \
        prev - mean[:, :, None]
    pre = f32(preemph)
    zr = [(e0[:, j] - pre * p[:, j]) * w_ev[j] for j in range(7)]
    zi = [(e1[:, j] - pre * e0[:, j]) * w_od[j] for j in range(7)]
    zr.append(np.zeros_like(zr[0]))
    zi.append(np.zeros_like(zi[0]))

    # pass 1: lane t, radix 8 over j, twiddle W256^(t q)
    re, im = _dft8(zr, zi)
    for q in range(1, 8):
        re[q], im[q] = _mul_conj(re[q], im[q], 2 * LANE * q)
    # exchange 1: lane 4 q + t0 takes element q of lanes t0 + 4 t1
    q2, t0 = LANE >> 2, LANE & 3
    re1, im1 = np.stack(re, 1), np.stack(im, 1)              # [N, q, t]
    re = [re1[:, q2, t0 + 4 * t1] for t1 in range(8)]
    im = [im1[:, q2, t0 + 4 * t1] for t1 in range(8)]
    # pass 2: radix 8 over t1, twiddle W32^(t0 r)
    re, im = _dft8(re, im)
    for r in range(1, 8):
        re[r], im[r] = _mul_conj(re[r], im[r], 16 * t0 * r)
    # exchange 2 and pass 3: lane q + 8 m, radix 4 over t0 for r = m, m + 4
    q3, m = LANE & 7, LANE >> 3
    re2, im2 = np.stack(re, 1), np.stack(im, 1)              # [N, r, L]
    zr, zi = [None] * 8, [None] * 8
    for rhi in range(2):
        cr = [re2[:, m + 4 * rhi, 4 * q3 + k] for k in range(4)]
        ci = [im2[:, m + 4 * rhi, 4 * q3 + k] for k in range(4)]
        cr, ci = _dft4(cr, ci)
        for s in range(4):
            zr[rhi + 2 * s], zi[rhi + 2 * s] = cr[s], ci[s]
    # lane M holds Z[M + 32 j]; split step with Z[256 - k] from lane 32 - M
    ar = np.stack(zr, 1).reshape(-1, 256)                    # [N, k]
    ai = np.stack(zi, 1).reshape(-1, 256)
    k = np.arange(256)
    br, bi = ar[:, (256 - k) & 255], -ai[:, (256 - k) & 255]
    sr, si, dr, di = ar + br, ai + bi, ar - br, ai - bi
    c, s = TW_COS[k], TW_SIN[k]
    xr = f32(0.5) * (sr + c * di - s * dr)
    xi = f32(0.5) * (si - c * dr - s * di)
    return xr * xr + xi * xi


def emulate_kernel(frames, num_mel_bins=80):
    """[N, 400] frames → [N, num_mel_bins] log-mel, as the kernel does it."""
    power = emulate_power(frames)
    _, band, weights = (t.numpy() for t in fbank_cuda._constants(
        torch.device('cpu'), num_mel_bins, 16000, 20.0, 0.0))
    mel = np.zeros((power.shape[0], num_mel_bins), f32)
    for m, (first, length, off) in enumerate(band):
        for i in range(length):
            mel[:, m] += weights[off + i] * power[:, first + i]
    return np.log(np.maximum(mel, f32(F.EPSILON)))


def _frames(samples, n):
    return np.stack([samples[i * 160:i * 160 + 400] for i in range(n)])


def _close(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.mean() < 1e-3, d.mean()
    assert d.max() < 0.05, d.max()
    return d.max()


def test_power_spectrum_equals_float64_fft():
    frames = _frames(speechlike(10960, seed=3), 67)
    x = frames.astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    y = (x - 0.97 * np.concatenate([x[:, :1], x[:, :-1]], axis=1)) \
        * F.povey_window(400)
    ref = np.abs(np.fft.rfft(y, n=512, axis=1)[:, :256]) ** 2
    err = np.abs(emulate_power(frames) - ref) / ref.max(axis=1, keepdims=True)
    assert err.max() < 2e-6, err.max()


@pytest.mark.parametrize('n', [1, 67, 997])
def test_emulated_kernel_matches_pallas_numpy_and_plain(n):
    samples = speechlike((n - 1) * 160 + 400, seed=n)
    frames = _frames(samples, n)
    got = emulate_kernel(frames)
    assert got.shape == (n, 80)
    _close(got, np.asarray(fbank_frames_pallas(jnp.asarray(frames),
                                               interpret=True)))
    _close(got, F.fbank_numpy(samples))
    plain = fbank_cuda.fbank_frames(torch.from_numpy(frames)).numpy()
    assert _close(got, plain) <= 5e-4


@pytest.mark.parametrize('num_mel_bins', [1, 40, 80, 256])
def test_mel_band_tables_expand_to_mel_banks(num_mel_bins):
    _, band, weights = (t.numpy() for t in fbank_cuda._constants(
        torch.device('cpu'), num_mel_bins, 16000, 20.0, 0.0))
    dense = np.zeros((num_mel_bins, 257), np.float32)
    for m, (first, length, off) in enumerate(band):
        dense[m, first:first + length] = weights[off:off + length]
    np.testing.assert_array_equal(
        dense, F.get_mel_banks(num_mel_bins, 512, 16000.0))
    assert band.dtype == np.int32 and weights.size <= fbank_cuda.MAX_WEIGHTS
    assert np.array_equal(band[:, 2], np.concatenate(
        [[0], np.cumsum(band[:-1, 1])]))


def test_empty_filter_gives_log_floor():
    _, band, _ = fbank_cuda._constants(torch.device('cpu'), 256, 16000,
                                       20.0, 0.0)
    empty = (band[:, 1] == 0).numpy()
    assert empty.any()
    samples = speechlike(2000, seed=4)
    frames = _frames(samples, 11)
    got = emulate_kernel(frames, 256)
    assert np.all(got[:, empty] == np.log(np.float32(F.EPSILON)))
    plain = fbank_cuda.fbank_frames(torch.from_numpy(frames), 256).numpy()
    np.testing.assert_array_equal(plain[:, empty], got[:, empty])
    _close(got, plain)
    _close(got, F.fbank_numpy(samples, num_mel_bins=256))
