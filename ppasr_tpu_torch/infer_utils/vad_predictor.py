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
log-RMS energy of each window against a running noise floor. A weight file
that exists but fails to load raises (the JAX predictor falls back to the
next scorer). The JAX package's own conv+LSTM ``VADModel`` for a
``vad_model.msgpack`` is not ported yet (ROADMAP Queue A, item 5): such a
file, with no Silero weights beside it, raises.
"""
import os

import numpy as np

from ppasr_tpu_torch.infer_utils.silero import SileroVAD


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
            raise NotImplementedError(
                "vad_model.msgpack (the JAX package's VADModel) is not "
                "ported yet (ROADMAP Queue A, item 5)")
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
