"""Voice activity detection for long-audio segmentation (counterpart of
``VADPredictor``, ppasr_tpu/infer_utils/vad_predictor.py:80-227).

``get_speech_timestamps`` segments a recording offline: speech starts at a
window whose probability reaches ``threshold`` and ends after
``min_silence_duration_ms`` below ``threshold − 0.15``; segments shorter
than ``min_speech_duration_ms`` are dropped and the rest padded by
``speech_pad_ms``. ``stream_vad`` emits start and end events as windows
arrive; ``reset_states`` clears both.

Scoring: the Silero VAD v3 weights (``model_dir/silero_vad_v3.npz``, else
the file committed as ``ppasr_tpu/assets/silero_vad_v3.npz``, read by path)
through ``infer_utils/silero.py`` on ``device``; without such a file, the
log-RMS energy of each window against a running noise floor; between the
two, the JAX package's own conv+LSTM ``VADModel`` (:21-72) for a
``model_dir/vad_model.msgpack`` with no Silero weights beside it. A weight
file that exists but fails to load raises (the JAX predictor falls back to
the next scorer).
"""
import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.infer_utils.silero import SileroVAD
from ppasr_tpu_torch.utils.checkpoint import convert_params, load_msgpack
from ppasr_tpu_torch.utils.precision import ieee_float32


class _VADNet(nn.Module):
    """4 strided conv1d layers (16, 32, 48, 64 channels, kernel 5, strides
    4, 4, 4, 2) with ReLU over a 512-sample window, a Dense(64), a
    one-layer LSTM(64) over the windows, and Dense(1) + sigmoid."""
    LAYERS = ((16, 4), (32, 4), (48, 4), (64, 2))

    def __init__(self):
        super().__init__()
        ch = 1
        for i, (feat, stride) in enumerate(self.LAYERS):
            self.add_module(f'Conv_{i}', nn.Conv1d(ch, feat, 5, stride=stride))
            ch = feat
        self.Dense_0 = nn.Linear(4 * ch, 64)
        self.cell = nn.LSTM(64, 64, batch_first=True)
        self.Dense_1 = nn.Linear(64, 1)

    def forward(self, windows, carry=None):
        """[N, 512] windows of one stream, in order → ([N] probabilities,
        the LSTM's (h, c) after the last)."""
        h = windows[:, None, :]
        for i, (_, stride) in enumerate(self.LAYERS):
            # flax's 'SAME' with a stride: ⌈L/s⌉ outputs, the padding's
            # smaller half before
            n = h.shape[-1]
            total = max((-(-n // stride) - 1) * stride + 5 - n, 0)
            h = F.pad(h, (total // 2, total - total // 2))
            h = F.relu(getattr(self, f'Conv_{i}')(h))
        h = self.Dense_0(h.transpose(1, 2).reshape(h.shape[0], -1))
        out, carry = self.cell(h[None], carry)
        return torch.sigmoid(self.Dense_1(out[0]))[:, 0], carry


class VADModel:
    """The JAX package's Silero-style frame classifier (:21-72) from
    ``model_dir/vad_model.msgpack`` on ``device``: the flax convs, Dense
    layers and ``OptimizedLSTMCell`` map onto ``_VADNet`` as
    ``utils/checkpoint.convert_params`` maps DeepSpeech2's cells. Stateful:
    the LSTM's carry runs on across calls until ``reset``."""

    def __init__(self, model_dir: str, device='cuda:0'):
        tree = load_msgpack(os.path.join(model_dir, 'vad_model.msgpack'))
        params = dict(tree['params'])
        params['cell'] = {'cell': params.pop('OptimizedLSTMCell_0')}
        self.device = torch.device(device)
        self.net = _VADNet()
        self.net.load_state_dict(convert_params(params), strict=True)
        self.net.to(self.device).eval()
        self._carry = None

    def reset(self):
        self._carry = None

    @torch.inference_mode()
    def __call__(self, windows: np.ndarray) -> np.ndarray:
        """[N, 512] windows → [N] speech probabilities (stateful)."""
        x = torch.from_numpy(np.ascontiguousarray(windows, np.float32))
        with ieee_float32():
            probs, self._carry = self.net(x.to(self.device), self._carry)
        return probs.cpu().numpy()


def packaged_silero_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, 'ppasr_tpu', 'assets', 'silero_vad_v3.npz')


class VADPredictor:
    def __init__(self, window_size_samples: int = 512,
                 sampling_rate: int = 16000, model_dir: str = None,
                 device='cuda:0'):
        self.window_size_samples = window_size_samples
        self.sampling_rate = sampling_rate
        self.model = None
        candidates = [packaged_silero_path()]
        if model_dir:
            candidates.insert(0, os.path.join(model_dir, 'silero_vad_v3.npz'))
        path = next((p for p in candidates if os.path.exists(p)), None)
        if path is not None:
            self.model = SileroVAD(path, 16000 if sampling_rate >= 16000
                                   else 8000, device=device)
        elif model_dir and os.path.exists(os.path.join(model_dir,
                                                       'vad_model.msgpack')):
            self.model = VADModel(model_dir, device=device)
        self.reset_states()

    def reset_states(self):
        self._stream_buf = np.zeros(0, np.float32)
        self._stream_pos = 0
        self._triggered = False
        self._temp_end = 0
        self._noise_floor = None
        if self.model is not None:
            self.model.reset()

    # ------------------------------------------------------------- scoring

    def _frame_probs(self, wav: np.ndarray) -> np.ndarray:
        """[number of whole windows] speech probabilities."""
        w = self.window_size_samples
        n = len(wav) // w
        if n == 0:
            return np.zeros(0, np.float32)
        frames = wav[:n * w].reshape(n, w)
        if self.model is not None:
            return self.model(frames)
        rms_db = 10 * np.log10(np.mean(frames ** 2, axis=1) + 1e-10)
        floor = self._noise_floor
        if floor is None:
            floor = np.percentile(rms_db, 10)
        # a running floor for streaming use
        self._noise_floor = floor if self._noise_floor is None \
            else 0.95 * self._noise_floor + 0.05 * np.percentile(rms_db, 10)
        # about 12 dB above the floor is confident speech
        return 1.0 / (1.0 + np.exp(-(rms_db - floor - 6.0) / 3.0))

    # ------------------------------------------------------------- offline

    def get_speech_timestamps(self, wav: np.ndarray, threshold: float = 0.5,
                              min_speech_duration_ms: int = 250,
                              min_silence_duration_ms: int = 100,
                              speech_pad_ms: int = 30):
        """→ [{'start': sample, 'end': sample}, ...]."""
        wav = np.asarray(wav, np.float32)
        sr, w = self.sampling_rate, self.window_size_samples
        self._noise_floor = None
        if self.model is not None:
            self.model.reset()   # a fresh LSTM state per recording
        probs = self._frame_probs(wav)
        neg_threshold = threshold - 0.15
        min_speech = sr * min_speech_duration_ms / 1000
        min_silence = sr * min_silence_duration_ms / 1000
        pad = int(sr * speech_pad_ms / 1000)

        speeches = []
        triggered = False
        current = {}
        temp_end = 0
        for i, p in enumerate(probs):
            pos = i * w
            if p >= threshold and temp_end:
                temp_end = 0
            if p >= threshold and not triggered:
                triggered = True
                current = {'start': pos}
                continue
            if p < neg_threshold and triggered:
                if not temp_end:
                    temp_end = pos
                if pos - temp_end < min_silence:
                    continue
                current['end'] = temp_end
                if current['end'] - current['start'] > min_speech:
                    speeches.append(current)
                current = {}
                triggered = False
                temp_end = 0
        if triggered and current:
            current['end'] = len(wav)
            if current['end'] - current['start'] > min_speech:
                speeches.append(current)

        for s in speeches:
            s['start'] = int(max(0, s['start'] - pad))
            s['end'] = int(min(len(wav), s['end'] + pad))
        return speeches

    # ------------------------------------------------------------ streaming

    def stream_vad(self, chunk: np.ndarray, threshold: float = 0.5,
                   min_silence_duration_ms: int = 100):
        """Feed samples; → list of {'start': sample} / {'end': sample}
        events."""
        sr, w = self.sampling_rate, self.window_size_samples
        self._stream_buf = np.concatenate(
            [self._stream_buf, np.asarray(chunk, np.float32)])
        min_silence = sr * min_silence_duration_ms / 1000
        neg_threshold = threshold - 0.15
        events = []
        while len(self._stream_buf) >= w:
            window = self._stream_buf[:w]
            self._stream_buf = self._stream_buf[w:]
            p = float(self._frame_probs(window)[0])
            pos = self._stream_pos
            self._stream_pos += w
            if p >= threshold and self._temp_end:
                self._temp_end = 0
            if p >= threshold and not self._triggered:
                self._triggered = True
                events.append({'start': pos})
                continue
            if p < neg_threshold and self._triggered:
                if not self._temp_end:
                    self._temp_end = pos
                if pos - self._temp_end >= min_silence:
                    events.append({'end': self._temp_end + w})
                    self._triggered = False
                    self._temp_end = 0
        return events
