"""Kernel B1 (ppasr_tpu_torch/csrc/fbank.cu) against its plain PyTorch
version and the host ``fbank_numpy`` on the card, through each of its
wrappers: a streaming window, [N, 400] frames, and ``fbank_batch``'s one
stride-160 launch over a flat [B·S] batch. CUDA C++ has no CPU mode,
so these tests skip without a card. The file imports no JAX, so it also
runs on a machine that has only the port's packages:

    python -m pytest --noconftest -m gpu tests/test_torch_fbank_cuda.py

Tolerance: mean |Δ| < 1e-3 and max |Δ| < 0.05 log-mel, as for the plain
version against the JAX package (tests/test_torch_fbank.py)."""
import os
import sys

import numpy as np
import pytest
import torch

from ppasr_tpu_torch.ops import fbank as F
from ppasr_tpu_torch.ops import fbank_cuda

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_torch_smoke_fixture import speechlike  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA C++ and has no CPU mode; needs a card")
    return torch.device('cuda:0')


def _close(a, b):
    d = (torch.as_tensor(a).double().cpu() - torch.as_tensor(b).double()).abs()
    assert d.mean().item() < 1e-3 and d.max().item() < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize('n', [1, 5, 67, 997])   # eight frames a block
def test_kernel_matches_plain_version_on_card(n):
    dev = _card()
    samples = speechlike((n - 1) * 160 + 400, seed=n)
    wav = torch.from_numpy(samples).to(dev)
    before = fbank_cuda.launches
    got = fbank_cuda.fbank_window(wav, n)
    frames = fbank_cuda.fbank_frames(
        F.frame_torch(wav[None], 400, 160, n)[0].contiguous())
    torch.cuda.synchronize()
    assert fbank_cuda.launches == before + 2
    assert got.shape == frames.shape == (n, 80)
    plain = fbank_cuda.fbank_window(wav.cpu(), n)
    _close(got, plain)
    _close(frames, plain)
    _close(got, F.fbank_numpy(samples))


@pytest.mark.gpu
def test_kernel_stride_400_batch_on_card():
    """bench.py's batch: 16 × 10 s framed into [15,968, 400]."""
    dev = _card()
    batch = [speechlike(160000, seed=s) for s in range(16)]
    frames = np.concatenate([F.frame_torch(torch.from_numpy(w)[None], 400,
                                           160, 998)[0].numpy()
                             for w in batch])
    before = fbank_cuda.launches
    got = fbank_cuda.fbank_frames(torch.from_numpy(frames).to(dev))
    torch.cuda.synchronize()
    assert fbank_cuda.launches == before + 1
    assert got.shape == (15968, 80)
    _close(got, fbank_cuda.fbank_frames(torch.from_numpy(frames)))
    _close(got, np.concatenate([F.fbank_numpy(w) for w in batch]))


@pytest.mark.gpu
@pytest.mark.parametrize('n', [1, 67, 997])
def test_kernel_reads_base_pointer_at_odd_offset(n):
    """A view one sample into its storage is 4-byte aligned only."""
    dev = _card()
    samples = speechlike((n - 1) * 160 + 401, seed=n + 1)
    wav = torch.from_numpy(samples).to(dev)[1:]
    assert wav.data_ptr() % 8 == 4 and wav.is_contiguous()
    before = fbank_cuda.launches
    got = fbank_cuda.fbank_window(wav, n)
    torch.cuda.synchronize()
    assert fbank_cuda.launches == before + 1
    _close(got, fbank_cuda.fbank_window(wav.cpu(), n))
    _close(got, F.fbank_numpy(samples[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize('num_mel_bins', [40, 80, 256])
def test_kernel_num_mel_bins_on_card(num_mel_bins):
    dev = _card()
    samples = speechlike(66 * 160 + 400, seed=num_mel_bins)
    wav = torch.from_numpy(samples).to(dev)
    before = fbank_cuda.launches
    got = fbank_cuda.fbank_window(wav, 67, num_mel_bins)
    torch.cuda.synchronize()
    assert fbank_cuda.launches == before + 1
    assert got.shape == (67, num_mel_bins)
    _close(got, fbank_cuda.fbank_window(wav.cpu(), 67, num_mel_bins))
    _close(got, F.fbank_numpy(samples, num_mel_bins=num_mel_bins))


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_cannot_take():
    dev = _card()
    with pytest.raises(TypeError):
        fbank_cuda.fbank_window(torch.zeros(800, dtype=torch.float64,
                                            device=dev), 2)
    with pytest.raises(ValueError):          # too few samples for 3 frames
        fbank_cuda.fbank_window(torch.zeros(700, device=dev), 3)
    with pytest.raises(ValueError):
        fbank_cuda.fbank_frames(torch.zeros(400, 4, device=dev).t())
    assert fbank_cuda.fbank_window(torch.zeros(399, device=dev),
                                   0).shape == (0, 80)


def _ragged(bsz, s, seed):
    """[B, S] speech-like rows zeroed past ragged lengths, and the lengths
    (the first row full, the others shorter, one under 400 samples when
    B > 2)."""
    rng = np.random.default_rng(seed)
    lengths = np.array([s] + [int(rng.integers(400, s)) for _ in
                              range(bsz - 1)], np.int32)
    if bsz > 2:
        lengths[-1] = 399
    wavs = np.stack([speechlike(s, seed=seed + b) for b in range(bsz)])
    for row, n in zip(wavs, lengths):
        row[n:] = 0.0
    return wavs, lengths


def _check_batch(wavs, lengths):
    """One fbank_batch launch on the card against fbank_batch_torch."""
    before = fbank_cuda.launches
    got, got_lens = fbank_cuda.fbank_batch(wavs, lengths)
    torch.cuda.synchronize()
    assert fbank_cuda.launches == before + 1
    want, want_lens = F.fbank_batch_torch(wavs.cpu(), lengths.cpu())
    assert got.shape == want.shape
    assert torch.equal(got_lens.cpu(), want_lens)
    _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize('s', [16000, 48000])
@pytest.mark.parametrize('bsz', [1, 3, 5])
def test_batch_launch_matches_plain_version_on_card(bsz, s):
    dev = _card()
    wavs, lengths = _ragged(bsz, s, seed=bsz * 7 + s // 16000)
    _check_batch(torch.from_numpy(wavs).to(dev), torch.from_numpy(lengths))


@pytest.mark.gpu
def test_batch_launch_from_base_pointer_at_odd_offset():
    dev = _card()
    wavs, lengths = _ragged(3, 16000, seed=5)
    buf = torch.from_numpy(np.concatenate([[0.0], wavs.ravel()]).astype(
        np.float32)).to(dev)
    shifted = buf[1:].view(3, 16000)
    assert shifted.data_ptr() % 8 == 4 and shifted.is_contiguous()
    _check_batch(shifted, torch.from_numpy(lengths))


@pytest.mark.gpu
def test_batch_launch_rejects_rows_off_the_hop():
    dev = _card()
    before = fbank_cuda.launches
    with pytest.raises(ValueError, match='multiple of 160'):
        fbank_cuda.fbank_batch(torch.zeros(2, 16080 + 1, device=dev),
                               torch.tensor([16081, 400], device=dev))
    with pytest.raises(ValueError, match='contiguous'):
        fbank_cuda.fbank_batch(torch.zeros(16000, 2, device=dev).t(),
                               torch.tensor([16000, 400], device=dev))
    assert fbank_cuda.launches == before
