"""Silero VAD v3 in PyTorch (counterpart of
ppasr_tpu/infer_utils/silero_jax.py:39-157), from the weights committed as
``ppasr_tpu/assets/silero_vad_v3.npz`` (read by path; one sample-rate
branch, ``16k.*`` or ``8k.*``).

Per window of W samples:

- reflect-pad by ``reflect_pad`` (96) on each side, then a stride-64 conv1d
  with the [258, 1, 256] STFT basis (window and real DFT fused): magnitude
  of the 129 bins, and spect = log1p(magnitude · mag_scale);
- adaptive norm: the mean over bins, reflect-padded by 3, smoothed by the
  7-tap filter, averaged over time and taken from spect;
- [magnitude, norm] (258 channels) through the depthwise-separable blocks
  (dw5 → relu → pw, plus a 1×1 projection or the identity, relu), with
  stride-2 1×1 downsamplings between them and a final 1×1 conv;
- a 2-layer LSTM (hidden 64) over the frames, relu, a 1×1 conv to one
  channel, sigmoid, and the mean over the window's frames.

The npz holds the LSTM as ONNX does: W [4H, in], R [4H, H] and B [8H] with
the gates in i, o, f, c order; ``lstm_from_onnx`` reorders them into
``nn.LSTM``'s i, f, g, o. The conv frontend is stateless, so
``score_windows`` runs N consecutive windows as one batch and the LSTM once
over their N·T' frames in order, which is the same as feeding the windows
one at a time.
"""
import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

HIDDEN = 64


def lstm_from_onnx(w, r, b):
    """ONNX LSTM weights (gates i, o, f, c) → ``nn.LSTM``'s (weight_ih,
    weight_hh, bias_ih, bias_hh) with the gates in i, f, g(=c), o."""
    def reorder(x):
        i, o, f, c = np.split(np.asarray(x), 4, axis=0)
        return np.concatenate([i, f, c, o], axis=0)
    b = np.asarray(b)
    half = b.shape[0] // 2
    return reorder(w), reorder(r), reorder(b[:half]), reorder(b[half:])


def load_branch(npz_path: str, sample_rate: int = 16000):
    """npz → (float arrays by name, integer settings by name) of the
    branch for ``sample_rate``."""
    prefix = '16k.' if sample_rate == 16000 else '8k.'
    raw = np.load(npz_path)
    params, config = {}, {}
    for key in raw.files:
        if key.startswith(prefix):
            name, val = key[len(prefix):], raw[key]
            if val.dtype == np.float32:
                params[name] = val
            else:
                config[name] = int(val)
    if not params:
        raise ValueError(f'no {prefix}* arrays in {npz_path}')
    return params, config


class SileroNet(nn.Module):
    def __init__(self, params: dict, config: dict):
        super().__init__()
        self.config = dict(config)
        for name, val in params.items():
            if not name.startswith(('lstm1.', 'lstm2.')):
                self.register_buffer(name.replace('.', '_'),
                                     torch.from_numpy(np.array(val)))
        self.lstm = nn.LSTM(HIDDEN, HIDDEN, num_layers=2)
        with torch.no_grad():
            for layer, key in enumerate(('lstm1', 'lstm2')):
                ih, hh, b_ih, b_hh = lstm_from_onnx(params[f'{key}.W'],
                                                    params[f'{key}.R'],
                                                    params[f'{key}.B'])
                for attr, val in (('weight_ih', ih), ('weight_hh', hh),
                                  ('bias_ih', b_ih), ('bias_hh', b_hh)):
                    getattr(self.lstm, f'{attr}_l{layer}').copy_(
                        torch.from_numpy(val))

    def p(self, name):
        return getattr(self, name.replace('.', '_'))

    def _sep_block(self, x, key):
        ch = x.shape[1]
        h = F.relu(F.conv1d(x, self.p(f'{key}.dw_w'), self.p(f'{key}.dw_b'),
                            padding=2, groups=ch))
        h = F.conv1d(h, self.p(f'{key}.pw_w'), self.p(f'{key}.pw_b'))
        res = (F.conv1d(x, self.p(f'{key}.proj_w'), self.p(f'{key}.proj_b'))
               if hasattr(self, f'{key}_proj_w') else x)
        return F.relu(h + res)

    def encode_windows(self, x):
        """[B, W] samples → [B, T', 64] features (stateless)."""
        pad = self.config['reflect_pad']
        x = F.pad(x[:, None, :], (pad, pad), mode='reflect')
        ft = F.conv1d(x, self.p('stft_basis'), stride=64)      # [B, 258, F]
        nbin = ft.shape[1] // 2
        mag = torch.sqrt(ft[:, :nbin] ** 2 + ft[:, nbin:] ** 2)
        spect = torch.log1p(mag * self.p('mag_scale'))
        mean = spect.mean(dim=1, keepdim=True)                  # [B, 1, F]
        smooth = F.conv1d(F.pad(mean, (3, 3), mode='reflect'),
                          self.p('an_filter'))
        norm = spect - smooth.mean(dim=2, keepdim=True)
        h = self._sep_block(torch.cat([mag, norm], dim=1), 'first')
        for down, block in (('down0', 'block1'), ('down1', 'block2'),
                            ('down2', 'block3')):
            h = F.relu(F.conv1d(h, self.p(f'{down}_w'), self.p(f'{down}_b'),
                                stride=self.config[f'{down}_stride']))
            h = self._sep_block(h, block)
        h = F.relu(F.conv1d(h, self.p('final_w'), self.p('final_b')))
        return h.transpose(1, 2)

    def score_windows(self, windows, h, c):
        """[N, W] consecutive windows of one stream and the LSTM state
        (h, c each [2, 1, 64]) → ([N] speech probabilities, h, c)."""
        feats = self.encode_windows(windows)                    # [N, T', 64]
        n, t, d = feats.shape
        outs, (h, c) = self.lstm(feats.reshape(n * t, 1, d), (h, c))
        dec = F.relu(outs[:, 0, :]) @ self.p('dec_w')[:, :, 0].T \
            + self.p('dec_b')
        return torch.sigmoid(dec).reshape(n, t).mean(dim=1), h, c


class SileroVAD:
    """The stateful scorer: consecutive windows carry the LSTM state;
    ``reset()`` between streams. Runs on ``device``."""

    def __init__(self, npz_path: str, sample_rate: int = 16000,
                 device='cuda:0'):
        self.device = torch.device(device)
        self.net = SileroNet(*load_branch(npz_path, sample_rate)).to(
            self.device).eval()
        self.reset()

    def reset(self):
        self._h = torch.zeros(2, 1, HIDDEN, device=self.device)
        self._c = torch.zeros(2, 1, HIDDEN, device=self.device)

    @torch.inference_mode()
    def __call__(self, windows: np.ndarray) -> np.ndarray:
        """[N, W] consecutive windows → [N] speech probabilities."""
        if windows.size == 0:
            return np.zeros(0, np.float32)
        x = torch.from_numpy(np.ascontiguousarray(windows, np.float32))
        probs, self._h, self._c = self.net.score_windows(
            x.to(self.device), self._h, self._c)
        return probs.cpu().numpy()
