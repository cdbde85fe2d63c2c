"""Batched multi-stream streaming engine (counterpart of
ppasr_tpu/serving.py:30-256, ``StreamingBatchEngine``).

N streams share one batched device state: the encoder's ``StreamingState``
is allocated with batch size ``max_streams`` on the predictor's device, each
tick runs one chunk step for every slot, and a masked select keeps the
state of the slots that had no window ready. Per-stream feature buffers,
gain tracking and greedy decoders live on the host; the attention and
convolution caches never leave the device. Features are made on the host
through the predictor's ``stream_featurizer``, as the JAX engine makes them.

The engine lock guards both the slot bookkeeping and the batch state; every
chunk step also runs under ``predict.ieee_float32()``. Every family's state
is served (:42-56, :66-100): ``stream_axes`` names the stream axis of each
field of the Conformer's ``StreamingState``, DeepSpeech2's ``DS2State``
and the per-layer tuples of ``SqueezeformerState`` and ``EffConState``,
and raises ``TypeError`` for any other state. DeepSpeech2's step takes the
window length of every slot, the full window's even at a flush (:70-76),
and has no rescorer; each slot's output frames are divided by the model's
``output_factor`` (:247-250).

With a predictor built with ``decoder='attention_rescoring'``, each tick
also keeps every slot's encoder output and posteriors on the device, and a
stream's last ``feed`` (``is_end``) returns the predictor's rescorer's pass
over them (:47-52, :62, :76-79, :135-143); the partial results stay
greedy. The engine runs in the predictor's compute dtype.

``ticks``, ``windows`` and ``tick_seconds`` count the batched chunk steps,
the slot-windows they served and their host time. While a profiler
records (``utils/trace``), each ``feed`` records ``engine.feed`` around
``engine.lock`` (the wait for the lock), ``engine.featurize`` and one
``engine.tick`` per batched step, which holds ``engine.assemble``,
``engine.upload``, ``engine.step``, ``engine.select``, ``engine.fetch`` and
``engine.decode``.
"""
import threading
import time
from typing import Optional

import numpy as np
import torch

from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.decoders.greedy import GreedyStreamingDecoder
from ppasr_tpu_torch.models.conformer_encoder import StreamingState
from ppasr_tpu_torch.models.deepspeech2 import DS2State
from ppasr_tpu_torch.models.efficient_conformer import EffConState
from ppasr_tpu_torch.models.squeezeformer import SqueezeformerState
from ppasr_tpu_torch.predict import ieee_float32
from ppasr_tpu_torch.utils.trace import span


def tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped NamedTuples and tuples,
    rebuilt as the first tree is."""
    first = trees[0]
    if isinstance(first, tuple):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, '_fields') \
            else tuple(out)
    return fn(*trees)


class StreamingBatchEngine:
    def __init__(self, predictor, max_streams: int = 16):
        """``predictor``: a constructed streaming ``PPASRPredictor``, which
        provides the model, its device, the featurizer and the chunk math."""
        if not predictor.streaming:
            raise ValueError("predictor was built non-streaming")
        self.p = predictor
        self.max_streams = max_streams
        self.model = predictor.model
        self.device = predictor.device
        with torch.inference_mode():
            self._batch_state = self.model.init_state(
                max_streams, predictor.cache_size, self.device)
        self._axes = self.stream_axes(self._batch_state)
        self._rescorer = predictor._rescorer
        self._ds2 = predictor.use_model == 'deepspeech2'

        self._lock = threading.Lock()
        self._free = list(range(max_streams))
        self._buffers = {}     # slot -> np feature buffer
        self._wav_tail = {}    # slot -> un-framed samples
        self._decoders = {}    # slot -> GreedyStreamingDecoder
        self._gain = {}        # slot -> [sq_sum, n]
        self._rescore_chunks = {}  # slot -> ([enc...], [probs...])
        self.ticks = 0         # batched chunk steps run
        self.windows = 0       # slot-windows those steps served
        self.tick_seconds = 0.0  # host clock over them, results on the host

    @staticmethod
    def stream_axes(state):
        """The stream axis of each state field, as a tree of the state's
        shape (explicit: guessing by size breaks where another dimension
        equals the stream count)."""
        if isinstance(state, StreamingState):
            return StreamingState(0, 0, 1, 1, 1)
        if isinstance(state, DS2State):
            return DS2State(1, 1)
        if isinstance(state, (SqueezeformerState, EffConState)):
            return type(state)(0, 0, *(tuple(0 for _ in field)
                                       for field in state[2:]))
        raise TypeError(f"unknown state type: {type(state)}")

    def _select(self, mask, new_state, old_state):
        """New state for the slots in ``mask`` ([S] bool on the device),
        the old state for the others."""
        def sel(axis, n, o):
            shape = [1] * n.ndim
            shape[axis] = mask.shape[0]
            return torch.where(mask.reshape(shape), n, o)
        return tree_map(sel, self._axes, new_state, old_state)

    # StreamingState.offset and cache_len are per-stream vectors: each slot's
    # positional window and cache-validity mask advance only on its own
    # ticks, so staggered streams are exact.

    # -------------------------------------------------------------- lifecycle

    def open_stream(self) -> Optional[int]:
        """A free slot with its state zeroed, or None when all are taken."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
            self._buffers[slot] = None
            self._wav_tail[slot] = np.zeros(0, np.float32)
            self._decoders[slot] = GreedyStreamingDecoder(self.p.vocab_list)
            self._gain[slot] = [0.0, 0]
            if self._rescorer is not None:
                self._rescore_chunks[slot] = ([], [])
            self._zero_slot(slot)
        return slot

    def close_stream(self, slot: int):
        with self._lock:
            for d in (self._buffers, self._wav_tail, self._decoders,
                      self._gain, self._rescore_chunks):
                d.pop(slot, None)
            if slot not in self._free:
                self._free.append(slot)

    def _zero_slot(self, slot: int):
        with torch.inference_mode():
            tree_map(lambda axis, x: x.select(axis, slot).zero_(),
                     self._axes, self._batch_state)

    # ------------------------------------------------------------------ feed

    def feed(self, slot: int, audio_data, is_end: bool = False,
             sample_rate: int = 16000) -> dict:
        """Feed PCM (bytes or float ndarray) for one stream; returns the
        stream's current hypothesis {'text', 'score'}, at ``is_end`` the
        rescored one when the predictor rescores."""
        with span('engine.feed'):
            if isinstance(audio_data, bytes):
                audio = AudioSegment.from_pcm_bytes(audio_data,
                                                    sample_rate=sample_rate)
            else:
                audio = AudioSegment.from_ndarray(
                    np.asarray(audio_data, np.float32), sample_rate)
            if audio.sample_rate != 16000:
                audio.resample(16000)
            s = audio.samples
            with span('engine.lock'):
                self._lock.acquire()
            try:
                if slot not in self._gain:
                    raise KeyError(f"stream slot {slot} is not open")
                if len(s):
                    self._gain[slot][0] += float(
                        np.sum(s.astype(np.float64) ** 2))
                    self._gain[slot][1] += len(s)
                self._wav_tail[slot] = np.concatenate(
                    [self._wav_tail[slot], s])

                if len(self._wav_tail[slot]) >= 400:
                    seg = AudioSegment(self._wav_tail[slot].copy(), 16000)
                    with span('engine.featurize'):
                        feat = self.p.stream_featurizer.featurize(seg)
                    t = feat.shape[0]
                    if t > 0:
                        self._wav_tail[slot] = self._wav_tail[slot][t * 160:]
                        buf = self._buffers[slot]
                        self._buffers[slot] = feat if buf is None \
                            else np.concatenate([buf, feat])

                self._tick(flush_slot=slot if is_end else None)
                score, text = self._decoders[slot].current()
                if is_end and self._rescore_chunks.get(slot, ([], []))[1]:
                    score, text = self._rescore(slot)
            finally:
                self._lock.release()
        return {'text': text, 'score': score}

    @torch.inference_mode()
    @ieee_float32()
    def _rescore(self, slot: int):
        """The final rescoring pass over one stream's chunks, which it
        clears. Called with the engine lock held."""
        encs, prbs = self._rescore_chunks[slot]
        self._rescore_chunks[slot] = ([], [])
        return self._rescorer.rescore_utterance(encs, prbs)

    # ------------------------------------------------------------------ tick

    def _gain_offset(self, slot: int) -> float:
        if self.p._stream_target_db is None or not self._gain[slot][1]:
            return 0.0
        sq, n = self._gain[slot]
        rms_db = 10.0 * np.log10(sq / n + 1e-20)
        return float(min(self.p._stream_target_db - rms_db, 300.0)
                     * np.log(10.0) / 10.0)

    @torch.inference_mode()
    @ieee_float32()
    def _tick(self, flush_slot: Optional[int] = None):
        """Batch one chunk step over every slot with a ready window, until
        none is ready. Called with the engine lock held."""
        win, stride, ctx = (self.p.decoding_window, self.p.stride,
                            self.p.context)
        while True:
            ready = []          # (slot, whether a whole window is there)
            for slot, buf in self._buffers.items():
                if buf is None:
                    continue
                full = buf.shape[0] >= win
                if full or (flush_slot == slot and buf.shape[0] >= ctx):
                    ready.append((slot, full))
            if not ready:
                return
            with span('engine.tick'):
                with span('engine.assemble'):
                    windows = np.zeros((self.max_streams, win,
                                        self.p.input_dim), np.float32)
                    valid = np.zeros((self.max_streams,), np.int32)
                    for slot, full in ready:
                        buf = self._buffers[slot]
                        if full:
                            windows[slot] = buf[:win] + self._gain_offset(slot)
                            valid[slot] = win
                            self._buffers[slot] = buf[stride:]
                        else:       # the flushed stream's last frames
                            t = buf.shape[0]
                            windows[slot, :t] = buf + self._gain_offset(slot)
                            valid[slot] = t
                            self._buffers[slot] = None
                t0 = time.perf_counter()
                with span('engine.upload'):
                    mask = torch.from_numpy(valid > 0).to(self.device)
                    xs = torch.from_numpy(windows).to(self.device)
                enc = None
                with span('engine.step'):
                    if self._ds2:
                        probs, _, new_state = self.model.get_encoder_out_chunk(
                            xs, torch.full((self.max_streams,), win,
                                           device=self.device),
                            self._batch_state)
                    elif self._rescorer is None:
                        probs, new_state = self.model.get_encoder_out_chunk(
                            xs, self._batch_state)
                    else:
                        enc, probs, new_state = \
                            self.model.get_encoder_out_chunk_rescore(
                                xs, self._batch_state)
                with span('engine.select'):
                    self._batch_state = self._select(mask, new_state,
                                                     self._batch_state)
                with span('engine.fetch'):
                    probs_np = probs.cpu().numpy()
                self.ticks += 1
                self.windows += len(ready)
                self.tick_seconds += time.perf_counter() - t0
                factor = 1 if self._ds2 else self.model.output_factor
                with span('engine.decode'):
                    for slot, _ in ready:
                        n_out = ((int(valid[slot]) - ctx)
                                 // self.p.subsampling) + 1
                        n_out = max((n_out + factor - 1) // factor, 0)
                        self._decoders[slot].decode_chunk(
                            probs_np[slot][:n_out])
                        if enc is not None and slot in self._rescore_chunks:
                            encs, prbs = self._rescore_chunks[slot]
                            encs.append(enc[slot, :n_out])
                            prbs.append(probs[slot, :n_out])
