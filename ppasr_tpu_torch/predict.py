"""Inference runtime: offline, batched, long-audio and streaming
(counterpart of ppasr_tpu/predict.py:37-688), for the four model families
(``models/factory``).

- ``predict`` (:331-353): host fbank → padded 1-second bucket → full-context
  encoder → greedy, beam or rescoring decode.
- ``predict_batch`` (:355-431): the batch axis padded to a power of two, the
  time axis to ``time_bucket_frames``; the host frontend featurizes each
  utterance, the device frontend (``use_device_frontend=True``) pads the
  int16-scaled waveforms to a multiple of ``time_bucket_frames``·160
  samples and runs the fused fbank kernel once for the whole batch
  (``ops/fbank_cuda.fbank_batch``); one encoder pass; greedy decoding with
  the argmax on the device, or the beam search, which the on-device
  backend runs from the CTC logits (``get_encoder_logits``, :401-416), or
  attention rescoring; padding rows dropped. While a profiler records
  (``utils/trace``) it records ``predict.waveform`` (load, gain, int16
  rounding), ``predict.pad``, ``predict.upload``, ``predict.fbank``, or
  ``predict.featurize`` with the host frontend, ``predict.encoder`` and
  ``predict.decode``.
- ``predict_long`` (:433-462): Silero VAD segments (``infer_utils/
  vad_predictor``) through ``predict_batch`` in groups of at most 32,
  joined with ``，``.
- ``predict_stream`` (:480-605): the host-feature path, and with
  ``use_device_frontend=True`` the device path, where each raw window of
  (decoding_window−1)·160 + 400 samples goes through the fused fbank kernel
  (``ops/fbank_cuda.fbank_window``, stride 160) on the model's device.
  With attention rescoring, the partial results are greedy and the final
  one (``is_end``) is a rescoring pass over the encoder outputs and
  posteriors the chunk steps kept on the device (:641-661).
- ``_run_chunk`` and the running-RMS gain offset (:607-652), including the
  host round trip of the features between the fbank and the encoder. The
  chunk math is the JAX predictor's for every family (:140-150): a window
  of (chunk−1)·4 + 7 frames, a stride of chunk·4, (t − 7) // 4 + 1 output
  frames, divided (rounding up) by the model's ``output_factor`` (the
  EfficientConformer's strides); DeepSpeech2's step takes the window's
  frame count and returns its own output length (:632-635) and its state
  is the RNNs' (h, c). That math assumes ×4 subsampling: an input layer
  that subsamples otherwise streams wrongly in both packages (ROADMAP
  Queue C).
- The device frontend (``use_device_frontend=True``) is the fbank kernel:
  with ``feature_method`` ``'mfcc'`` or ``'linear'`` it raises, where the
  JAX predictor runs the fbank in the stream regardless and the host
  features in ``predict_batch`` (:182-196).
- ``_init_decoder`` (:216-287): ``decoder='ctc_beam_search'``, configured
  by ``decoder_configs`` or the configs' ``ctc_beam_search_decoder_conf``:
  ``backend`` ``'torch'`` (or ``'jax'``, the JAX package's name; the
  default) runs ``decoders/beam_search_torch`` on the model's device,
  ``'host'`` the numpy search and ``'native'`` the C++ one; an existing
  ``.klm`` language model goes to ``'native'``. ``decoder=
  'attention_rescoring'``: the on-device beam with the same options, then
  ``decoders/rescoring``; ``rescore_ctc_weight`` defaults to the model's
  ``ctc_weight`` and ``max_hyp_len`` to 200. DeepSpeech2 has no attention
  decoder: rescoring raises for it (JAX falls back to greedy, :233-235).
- ``use_pun`` and ``is_itn`` on every entry point: punctuation from
  ``infer_utils/pun_predictor`` on the model's device (``pun_model_dir``,
  else the committed artifact), then ``utils/itn``.

``compute_dtype='bfloat16'`` is the JAX model's ``dtype`` (:118-119), not
``torch.autocast``: the weights are cast to bf16 once, LayerNorms and the
CMVN stay float32, the attention scores and softmax are bf16, the streaming
caches are bf16, and the CTC posteriors and the decoder's scores are
float32 (``models/base.cast_for_compute``). The fbank features stay
float32 up to the subsampling layer.

Differences from the JAX predictor, on purpose: the model runs on
``cuda:0`` unless ``use_gpu=False``, and there is no fallback.
Every entry point that runs a model holds ``ieee_float32()``, which turns
TF32 and cuBLAS's reduced-precision bf16 reductions off while any caller
is inside (the JAX package's ``Precision.HIGHEST``, and XLA's float32
accumulation of bf16 products), whatever the process set. Without a card
``use_gpu=True`` raises; warm-up errors propagate; a beam or rescoring
decoder that fails to build raises (JAX falls back to greedy), and so does
a language model that exists but fails to load, a punctuation model that
fails to load (JAX returns the text unpunctuated), an unknown
``compute_dtype`` (JAX takes it as float32) and a missing
``mean_istd.json``. ITN is the in-repository rules: the JAX predictor
tries WeTextProcessing first. Punctuation and ITN apply on the device
frontend's stream too (the JAX device-frontend stream drops them).
"""
import json
import math
import os

import numpy as np
import torch

from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.data.featurizer.audio_featurizer import AudioFeaturizer
from ppasr_tpu_torch.data.featurizer.text_featurizer import TextFeaturizer
from ppasr_tpu_torch.decoders.beam_search_torch import TorchBeamSearchDecoder
from ppasr_tpu_torch.decoders.factory import DECODERS, build_decoder
from ppasr_tpu_torch.decoders.greedy import (GreedyStreamingDecoder,
                                             greedy_decoder,
                                             greedy_decoder_batch)
from ppasr_tpu_torch.decoders.rescoring import AttentionRescoringDecoder
from ppasr_tpu_torch.infer_utils.pun_predictor import PunctuationPredictor
from ppasr_tpu_torch.infer_utils.vad_predictor import VADPredictor
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.ops.fbank_cuda import fbank_batch, fbank_window
from ppasr_tpu_torch.utils.checkpoint import (convert_params,
                                              load_inference_params)
from ppasr_tpu_torch.utils.itn import inverse_normalize
from ppasr_tpu_torch.utils.logger import setup_logger
from ppasr_tpu_torch.utils.precision import ieee_float32  # noqa: F401
from ppasr_tpu_torch.utils.trace import span

logger = setup_logger(__name__)


def _batch_bucket(n: int) -> int:
    """The batch axis padded to a power of two, as the JAX predictor pads it
    to bound its compiled shapes; the padding rows have length 0."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class PPASRPredictor:
    def __init__(self, configs=None, model_path: str = None,
                 model_tag: str = None,
                 use_gpu: bool = True, decoder: str = None,
                 decoder_configs: dict = None,
                 use_pun: bool = False, pun_model_dir: str = None,
                 vocab_path: str = None, mean_istd_path: str = None,
                 decoding_chunk_size: int = 16,
                 num_decoding_left_chunks: int = -1,
                 time_bucket_frames: int = 100,
                 compute_dtype: str = 'float32',
                 use_device_frontend: bool = False):
        """Same signature as the JAX predictor (ppasr_tpu/predict.py:43-53).
        ``model_path``: exported directory with ``model.msgpack`` (else the
        int8 ``model_quant.msgpack``, dequantized at load) and
        ``inference.json``. ``use_gpu``: run on ``cuda:0`` (raises without
        a card) or on the CPU. ``use_pun``: load the punctuation model now
        (from ``pun_model_dir``, else the committed artifact) rather than at
        the first call that asks for it. ``compute_dtype``: ``'float32'``
        or ``'bfloat16'``."""
        if use_gpu and not torch.cuda.is_available():
            raise RuntimeError("use_gpu=True but torch.cuda.is_available() "
                               "is False; pass use_gpu=False for the CPU")
        self.device = torch.device('cuda:0' if use_gpu else 'cpu')
        if model_tag is not None:
            raise NotImplementedError("model_tag downloads are not ported: "
                                      "they need the network")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r} is not one of "
                             f"{sorted(_DTYPES)}")
        self.compute_dtype = _DTYPES[compute_dtype]
        self.configs = load_config(configs) if configs is not None else None
        with open(os.path.join(model_path, 'inference.json'), 'r',
                  encoding='utf-8') as f:
            infer_conf = json.load(f)
        self.use_model = infer_conf['use_model']
        self._model_conf = dict(infer_conf.get('model_conf') or {})
        self.streaming = infer_conf['streaming']
        self.input_dim = infer_conf['input_dim']
        self.vocab_size = infer_conf['vocab_size']
        self.time_bucket_frames = time_bucket_frames
        self.use_device_frontend = use_device_frontend

        bundled_istd = os.path.join(model_path, 'mean_istd.json')
        bundled_vocab = os.path.join(model_path, 'vocabulary.txt')
        if mean_istd_path is None and os.path.exists(bundled_istd):
            mean_istd_path = bundled_istd
        if vocab_path is None and os.path.exists(bundled_vocab):
            vocab_path = bundled_vocab
        if self.configs is not None:
            preprocess_conf = dict(self.configs.preprocess_conf)
            dataset_conf = self.configs.dataset_conf
            vocab_path = vocab_path or dataset_conf.dataset_vocab
            mean_istd_path = mean_istd_path or dataset_conf.mean_istd_path
            self.decoder_name = decoder or self.configs.get('decoder',
                                                            'ctc_greedy')
            self.decoder_configs = decoder_configs or dict(
                self.configs.get('ctc_beam_search_decoder_conf', {}) or {})
        else:
            preprocess_conf = {'feature_method': 'fbank',
                               'n_mels': self.input_dim}
            self.decoder_name = decoder or 'ctc_greedy'
            self.decoder_configs = decoder_configs or {}
        if self.decoder_name not in DECODERS:
            raise ValueError(f"unknown decoder {self.decoder_name!r}")

        self.audio_featurizer = AudioFeaturizer(**preprocess_conf,
                                                train=False)
        if use_device_frontend and \
                self.audio_featurizer._feature_method != 'fbank':
            raise ValueError(
                f"the device frontend computes fbank features only; "
                f"feature_method is "
                f"{self.audio_featurizer._feature_method!r}")
        # streaming featurizer: the gain comes from a running RMS estimate
        # (an additive log-mel offset per window), not from re-normalizing
        # each partial buffer
        stream_conf = dict(preprocess_conf)
        self._stream_target_db = stream_conf.pop('target_dB', -20) \
            if stream_conf.get('use_dB_normalization', True) else None
        stream_conf['use_dB_normalization'] = False
        self.stream_featurizer = AudioFeaturizer(**stream_conf, train=False)
        self.text_featurizer = TextFeaturizer(vocab_path)
        self.vocab_list = self.text_featurizer.vocab_list

        self.model = build_model(
            self.use_model, self.input_dim, self.vocab_size,
            streaming=self.streaming,
            encoder_conf=infer_conf.get('encoder_conf'),
            decoder_conf=infer_conf.get('decoder_conf'),
            model_conf=infer_conf.get('model_conf'),
            mean_istd_path=mean_istd_path)
        tree, artifact = load_inference_params(model_path)
        state_dict = convert_params(tree)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.model.set_compute_dtype(self.compute_dtype)
        logger.info(f"{self.use_model}: all {len(state_dict)} tensors of "
                    f"{artifact} loaded on {self.device}, computing in "
                    f"{compute_dtype}")

        # chunk math (ppasr_tpu/predict.py:140-150)
        self.decoding_chunk_size = decoding_chunk_size
        self.num_decoding_left_chunks = num_decoding_left_chunks
        self.subsampling = 4
        self.context = 7
        self.decoding_window = (decoding_chunk_size - 1) * self.subsampling \
            + self.context  # 67
        self.stride = decoding_chunk_size * self.subsampling  # 64
        left = num_decoding_left_chunks if num_decoding_left_chunks > 0 \
            else 16  # static cap emulating "all history"
        self.cache_size = decoding_chunk_size * left
        # one device window of decoding_window frames
        self._win_samples = (self.decoding_window - 1) * 160 + 400
        self._stride_samples = self.stride * 160

        self._pun_model_dir = pun_model_dir
        self._pun_predictor = None
        self._vad = None
        if use_pun:
            self._punctuation()
        self._init_decoder()
        self.reset_stream()
        self._warm_up()

    def _init_decoder(self):
        """The beam decoder of ``decoder='ctc_beam_search'`` or the
        rescorer of ``'attention_rescoring'`` (both None for greedy
        decoding), from ``decoder_configs`` (``decoders/factory``). Raises
        when it cannot be built."""
        decoder = build_decoder(self.decoder_name, self.decoder_configs,
                                self.vocab_list, self.model, self.use_model,
                                self._model_conf, self.device)
        rescoring = isinstance(decoder, AttentionRescoringDecoder)
        self._rescorer = decoder if rescoring else None
        self._beam_decoder = None if rescoring else decoder

    def _warm_up(self):
        warm = np.random.default_rng(0).uniform(
            -0.1, 0.1, 16000).astype(np.float32)
        self.predict(warm)
        if self.streaming:
            self.predict_stream(warm, is_end=True)
            self.reset_stream()

    # ------------------------------------------------------------- helpers

    def _load_audio(self, audio_data, sample_rate=16000) -> AudioSegment:
        """path / bytes / ndarray / AudioSegment → AudioSegment."""
        if isinstance(audio_data, AudioSegment):
            return audio_data
        if isinstance(audio_data, str):
            return AudioSegment.from_file(audio_data)
        if isinstance(audio_data, bytes):
            return AudioSegment.from_pcm_bytes(audio_data,
                                               sample_rate=sample_rate)
        if isinstance(audio_data, np.ndarray):
            return AudioSegment.from_ndarray(audio_data, sample_rate)
        raise TypeError(f"unsupported audio_data type: {type(audio_data)}")

    def _pad_bucket(self, feat: np.ndarray):
        t = feat.shape[0]
        bucket = max(self.time_bucket_frames,
                     int(math.ceil(t / self.time_bucket_frames))
                     * self.time_bucket_frames)
        padded = np.zeros((1, bucket, feat.shape[1]), np.float32)
        padded[0, :t] = feat
        return padded, t

    # -------------------------------------------------------------- offline

    @torch.inference_mode()
    @ieee_float32()
    def predict(self, audio_data, use_pun: bool = False,
                is_itn: bool = False, sample_rate: int = 16000):
        """Offline recognition → {'text', 'score'}."""
        audio = self._load_audio(audio_data, sample_rate)
        feat = self.audio_featurizer.featurize(audio)
        padded, t = self._pad_bucket(feat)
        xs = torch.from_numpy(padded).to(self.device)
        lens = torch.tensor([t], device=self.device)
        if self._rescorer is not None:
            score, text = self._rescorer.decode_batch_rescore(
                *self.model.encode_for_rescore(xs, lens))[0]
            return self._result(text, score, use_pun, is_itn)
        probs, olens = self.model.get_encoder_out(xs, lens)
        n = int(olens[0])
        if isinstance(self._beam_decoder, TorchBeamSearchDecoder):
            score, text = self._beam_decoder.decode(probs[0, :n])
        elif self._beam_decoder is not None:
            score, text = self._beam_decoder.decode(
                probs[0, :n].cpu().numpy())
        else:
            score, text = greedy_decoder(probs[0].cpu().numpy()[:n],
                                         self.vocab_list)
        return self._result(text, score, use_pun, is_itn)

    @torch.inference_mode()
    @ieee_float32()
    def predict_batch(self, audio_list, use_pun: bool = False,
                      is_itn: bool = False, sample_rate: int = 16000):
        """Batched offline recognition: list of path / bytes / ndarray /
        AudioSegment → list of {'text', 'score'}, one padded encoder pass
        and one batched decode."""
        if not audio_list:
            return []
        n = len(audio_list)
        if self.use_device_frontend:
            wav_batch, wlens = self._waveform_batch(audio_list, sample_rate)
            with span('predict.upload'):
                wavs = torch.from_numpy(wav_batch).to(self.device)
                wlens = torch.from_numpy(wlens).to(self.device)
            with span('predict.fbank'):
                batch, lens = fbank_batch(
                    wavs, wlens, num_mel_bins=self.input_dim,
                    sample_rate=self.audio_featurizer._target_sample_rate)
            del wavs, wlens     # the encoder's peak holds no waveforms
        else:
            with span('predict.featurize'):
                feats = [self.audio_featurizer.featurize(
                    self._load_audio(a, sample_rate)) for a in audio_list]
            with span('predict.pad'):
                max_t = max(f.shape[0] for f in feats)
                bucket = max(self.time_bucket_frames,
                             int(math.ceil(max_t / self.time_bucket_frames))
                             * self.time_bucket_frames)
                padded = np.zeros((_batch_bucket(n), bucket,
                                   feats[0].shape[1]), np.float32)
                flens = np.zeros((padded.shape[0],), np.int32)
                for i, f in enumerate(feats):
                    padded[i, :f.shape[0]] = f
                    flens[i] = f.shape[0]
            with span('predict.upload'):
                batch = torch.from_numpy(padded).to(self.device)
                lens = torch.from_numpy(flens).to(self.device)
        if self._rescorer is not None:
            with span('predict.encoder'):
                enc, probs, olens = self.model.encode_for_rescore(batch, lens)
            with span('predict.decode'):
                results = self._rescorer.decode_batch_rescore(
                    enc[:n], probs[:n], olens[:n])
        elif isinstance(self._beam_decoder, TorchBeamSearchDecoder):
            # softmax-free: candidates straight from the CTC logits
            with span('predict.encoder'):
                logits, olens = self.model.get_encoder_logits(batch, lens)
            with span('predict.decode'):
                results = self._beam_decoder.decode_batch_from_logits(
                    logits[:n], olens[:n])
        else:
            with span('predict.encoder'):
                probs, olens = self.model.get_encoder_out(batch, lens)
            with span('predict.decode'):
                if self._beam_decoder is not None:
                    results = self._beam_decoder.decode_batch(
                        probs[:n].cpu().numpy(), olens[:n].cpu().numpy())
                else:
                    results = greedy_decoder_batch(
                        probs[:n], olens[:n].cpu().numpy(), self.vocab_list)
        return [self._result(text, score, use_pun, is_itn)
                for score, text in results]

    @torch.inference_mode()
    @ieee_float32()
    def predict_long(self, audio_data, use_pun: bool = False,
                     is_itn: bool = False, sample_rate: int = 16000):
        """Long-audio recognition → {'text', 'score'}: the VAD's speech
        segments through ``predict_batch`` in groups of at most 32 (which
        bounds the padded activations of an hour-long recording), the
        non-empty texts joined with ``，``, the score their mean."""
        audio = self._load_audio(audio_data, sample_rate)
        if audio.sample_rate != 16000:
            audio.resample(16000)
        if self._vad is None:
            self._vad = VADPredictor(sampling_rate=audio.sample_rate,
                                     device=self.device)
        speeches = self._vad.get_speech_timestamps(audio.samples)
        if not speeches:
            speeches = [{'start': 0, 'end': audio.num_samples}]
        parts = [AudioSegment(audio.samples[seg['start']:seg['end']].copy(),
                              audio.sample_rate) for seg in speeches]
        results = []
        for i in range(0, len(parts), 32):
            results.extend(self.predict_batch(parts[i:i + 32],
                                              is_itn=is_itn))
        said = [r for r in results if r['text']]
        text = '，'.join(r['text'] for r in said)
        return self._result(
            text, float(np.mean([r['score'] for r in said])) if said
            else 0.0, use_pun, False)

    def _waveform_batch(self, audio_list, sample_rate: int = 16000):
        """The device frontend's input: ([b_bucket, S] int16-scaled float32
        waveforms, zero-padded, with S a multiple of
        ``time_bucket_frames``·160 samples; [b_bucket] int32 sample
        counts), as ppasr_tpu/predict.py:366-377 builds it."""
        with span('predict.waveform'):
            wavs = [self.audio_featurizer.waveform(
                self._load_audio(a, sample_rate)) for a in audio_list]
        with span('predict.pad'):
            samp_bucket = self.time_bucket_frames * 160
            max_s = max(max(len(w) for w in wavs), 400)
            max_s = int(math.ceil(max_s / samp_bucket)) * samp_bucket
            wav_batch = np.zeros((_batch_bucket(len(wavs)), max_s),
                                 np.float32)
            wlens = np.zeros((wav_batch.shape[0],), np.int32)
            for i, w in enumerate(wavs):
                wav_batch[i, :len(w)] = w
                wlens[i] = len(w)
        return wav_batch, wlens

    # ------------------------------------------------------------ streaming

    def reset_stream(self):
        """Clear wav/feature/device/decoder state."""
        self._remained_wav = np.zeros(0, np.float32)
        self._cached_feat = None
        self._state = None
        self._stream_sq_sum = 0.0
        self._stream_n = 0
        self._stream_enc_chunks = []
        self._stream_probs_chunks = []
        self._stream_decoder = GreedyStreamingDecoder(self.vocab_list)
        if self._beam_decoder is not None:
            self._beam_decoder.reset()

    @property
    def _chunk_decoder(self):
        """The decoder that consumes each window's posteriors."""
        return self._beam_decoder or self._stream_decoder

    @torch.inference_mode()
    @ieee_float32()
    def predict_stream(self, audio_data, is_end: bool = False,
                       use_pun: bool = False, is_itn: bool = False,
                       channels: int = 1, samp_width: int = 2,
                       sample_rate: int = 16000):
        """Incremental recognition → {'text', 'score'} for the utterance so
        far; at ``is_end`` with attention rescoring, the rescored one."""
        if not self.streaming:
            raise RuntimeError("model was built non-streaming; "
                               "use predict() instead")
        if isinstance(audio_data, bytes):
            audio = AudioSegment.from_pcm_bytes(audio_data, channels,
                                                samp_width, sample_rate)
        else:
            audio = self._load_audio(audio_data, sample_rate)
        if audio.sample_rate != 16000:
            audio.resample(16000)
        self._remained_wav = np.concatenate([self._remained_wav,
                                             audio.samples])
        if audio.num_samples:
            s = audio.samples
            self._stream_sq_sum += float(np.sum(s.astype(np.float64) ** 2))
            self._stream_n += len(s)

        if self.use_device_frontend:
            score, text = self._predict_stream_device(is_end)
        else:
            score, text = self._predict_stream_host(is_end)
        if is_end and self._stream_probs_chunks:
            score, text = self._rescorer.rescore_utterance(
                self._stream_enc_chunks, self._stream_probs_chunks)
        return self._result(text or '', score or 0.0, use_pun, is_itn)

    def _predict_stream_host(self, is_end):
        """Host-frontend streaming (ppasr_tpu/predict.py:509-555) →
        (score, text) of the chunk decoder."""
        # featurize everything buffered without gain; the running-RMS gain
        # is added per window as a log-mel offset in _run_chunk
        if len(self._remained_wav) >= 400:
            seg = AudioSegment(self._remained_wav.copy(), 16000)
            feat = self.stream_featurizer.featurize(seg)
            t = feat.shape[0]
            if t > 0:
                self._remained_wav = self._remained_wav[t * 160:]
                self._cached_feat = feat if self._cached_feat is None \
                    else np.concatenate([self._cached_feat, feat])

        result_text, result_score = None, None
        while (self._cached_feat is not None
               and self._cached_feat.shape[0] >= self.decoding_window):
            window = self._cached_feat[:self.decoding_window]
            self._cached_feat = self._cached_feat[self.stride:]
            result_score, result_text = self._chunk_decoder.decode_chunk(
                self._run_chunk(window))

        if is_end and self._cached_feat is not None \
                and self._cached_feat.shape[0] >= self.context:
            window = self._cached_feat       # flush the partial window
            self._cached_feat = None
            probs = self._run_chunk(window)
            if probs.shape[0] > 0:
                result_score, result_text = \
                    self._chunk_decoder.decode_chunk(probs)

        if result_text is None:
            result_score, result_text = self._chunk_decoder.current()
        return result_score, result_text

    def _device_featurize(self, window: np.ndarray) -> np.ndarray:
        """[win_samples] float32 PCM → [decoding_window, n_mels] log-mel
        through the fbank kernel on the model's device (the plain version on
        the CPU), then back to the host as in ppasr_tpu/predict.py:577-580."""
        wav = torch.from_numpy(np.clip(window * 32768.0, -32768, 32767))
        feat = fbank_window(wav.to(self.device), self.decoding_window,
                            num_mel_bins=self.input_dim)
        return feat.cpu().numpy()

    def _predict_stream_device(self, is_end):
        """Device-frontend streaming (ppasr_tpu/predict.py:569-605): raw PCM
        windows go through the fused fbank on the device; the host only
        slices sample buffers. → (score, text) of the chunk decoder."""
        result_text, result_score = None, None
        while len(self._remained_wav) >= self._win_samples:
            window = self._remained_wav[:self._win_samples]
            self._remained_wav = self._remained_wav[self._stride_samples:]
            probs = self._run_chunk(self._device_featurize(window))
            result_score, result_text = self._chunk_decoder.decode_chunk(
                probs)
        if is_end and len(self._remained_wav) >= self.context * 160 + 240:
            # flush: host featurize of the short tail
            seg = AudioSegment(self._remained_wav.copy(), 16000)
            feat = self.stream_featurizer.featurize(seg)
            self._remained_wav = np.zeros(0, np.float32)
            if feat.shape[0] >= self.context:
                probs = self._run_chunk(feat)
                if probs.shape[0] > 0:
                    result_score, result_text = \
                        self._chunk_decoder.decode_chunk(probs)
        if result_text is None:
            result_score, result_text = self._chunk_decoder.current()
        return result_score, result_text

    def _stream_gain_offset(self) -> float:
        """Additive log-mel offset from the running-RMS dB gain estimate."""
        if self._stream_target_db is None or not self._stream_n:
            return 0.0
        rms_db = 10.0 * np.log10(
            self._stream_sq_sum / self._stream_n + 1e-20)
        gain_db = min(self._stream_target_db - rms_db, 300.0)
        return float(gain_db * np.log(10.0) / 10.0)

    def _run_chunk(self, window_feat: np.ndarray) -> np.ndarray:
        """One encoder chunk step on the device; returns [T_out, V] probs.
        With attention rescoring, the step's encoder output and posteriors
        also stay on the device for the final pass."""
        window_feat = window_feat + self._stream_gain_offset()
        if self._state is None:
            self._state = self.model.init_state(1, self.cache_size,
                                                self.device)
        # pad short flush windows up to decoding_window
        t = window_feat.shape[0]
        if t < self.decoding_window:
            padded = np.zeros((self.decoding_window, window_feat.shape[1]),
                              np.float32)
            padded[:t] = window_feat
            window_feat = padded
        xs = torch.from_numpy(np.ascontiguousarray(
            window_feat[None], np.float32)).to(self.device)
        if self.use_model == 'deepspeech2':
            probs, olens, self._state = self.model.get_encoder_out_chunk(
                xs, torch.tensor([t], device=self.device), self._state)
            return probs[0, :int(olens[0])].cpu().numpy()
        valid_out = ((t - self.context) // self.subsampling) + 1
        factor = self.model.output_factor
        valid_out = (valid_out + factor - 1) // factor
        if self._rescorer is None:
            probs, self._state = self.model.get_encoder_out_chunk(
                xs, self._state)
        else:
            enc, probs, self._state = \
                self.model.get_encoder_out_chunk_rescore(xs, self._state)
            self._stream_enc_chunks.append(enc[0, :valid_out])
            self._stream_probs_chunks.append(probs[0, :valid_out])
        return probs[0, :valid_out].cpu().numpy()

    # ------------------------------------------------- punctuation & itn

    def _punctuation(self) -> PunctuationPredictor:
        """The punctuation model on the model's device, built at first
        use; a model that fails to load raises."""
        if self._pun_predictor is None:
            kwargs = {'model_dir': self._pun_model_dir} \
                if self._pun_model_dir else {}
            self._pun_predictor = PunctuationPredictor(device=self.device,
                                                       **kwargs)
        return self._pun_predictor

    def _result(self, text: str, score: float, use_pun: bool,
                is_itn: bool) -> dict:
        """{'text', 'score'}, the text punctuated and then normalized as
        asked (ppasr_tpu/predict.py:349-352)."""
        if use_pun and text:
            text = self._punctuation()(text)
        if is_itn and text:
            text = inverse_normalize(text)
        return {'text': text, 'score': score}
