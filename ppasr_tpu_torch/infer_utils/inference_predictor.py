"""Raw features in, CTC posteriors out, from an exported directory
(counterpart of ppasr_tpu/infer_utils/inference_predictor.py:1-174):
``predict``, ``predict_chunk_conformer``, ``predict_chunk_deepspeech`` and
``reset_stream``.

With the ``torch.export`` programs of ``infer_utils/torch_export`` for its
device (``offline.pt2`` and, for a streaming model, ``chunk.pt2``; the
card's are ``*.cuda.pt2``), it serves them with no model code: the
parameters are the msgpack artifact's ``state_dict`` (``model.msgpack``,
else ``model_quant.msgpack`` dequantized), the streaming state an opaque
tuple whose zeros come from the chunk program's input spec, and no module
of ``ppasr_tpu_torch.models`` is imported. Without them it builds the model
(``models/factory``) and calls the same entry points.

Every call runs under ``utils/precision.ieee_float32`` on ``cuda:0``
(``use_gpu=False``: the CPU); without a card ``use_gpu=True`` raises.
``PPASRPredictor`` layers featurization and decoding on top; use this
class for feature → posterior serving.
"""
import json
import os

import numpy as np
import torch

from ppasr_tpu_torch.infer_utils.torch_export import (MAX_FRAMES,
                                                      exported_args,
                                                      load_exported,
                                                      zero_state_from_exported)
from ppasr_tpu_torch.utils.checkpoint import (convert_params,
                                              load_inference_params)
from ppasr_tpu_torch.utils.logger import setup_logger
from ppasr_tpu_torch.utils.precision import ieee_float32

logger = setup_logger(__name__)


class InferencePredictor:
    def __init__(self, model_dir: str, mean_istd_path: str = None,
                 use_gpu: bool = True, use_stablehlo: bool = None):
        """``use_stablehlo`` (the JAX package's name; here the programs are
        ``torch.export``'s): None serves the programs when they are
        complete for the device (the offline one, and the chunk one for a
        streaming model), else the model code; True without them raises
        ``FileNotFoundError``; False always builds the model. In program
        mode ``mean_istd_path`` is ignored with a warning: the CMVN is in
        the program."""
        if use_gpu and not torch.cuda.is_available():
            raise RuntimeError("use_gpu=True but torch.cuda.is_available() "
                               "is False; pass use_gpu=False for the CPU")
        self.device = torch.device('cuda:0' if use_gpu else 'cpu')
        with open(os.path.join(model_dir, 'inference.json'), 'r',
                  encoding='utf-8') as f:
            conf = json.load(f)
        self.use_model = conf['use_model']
        self.streaming = conf['streaming']
        self.input_dim = conf['input_dim']
        self.vocab_size = conf['vocab_size']
        ds2 = self.use_model == 'deepspeech2'

        exp_off = exp_chunk = None
        if use_stablehlo is not False:
            exp_off, exp_chunk = load_exported(model_dir, self.device)
        # a streaming model needs both programs: offline alone would leave
        # the chunk calls broken, so auto mode takes the model code then
        complete = exp_off is not None and (exp_chunk is not None
                                            or not self.streaming)
        if use_stablehlo and not complete:
            raise FileNotFoundError(
                f"use_stablehlo=True but the {self.device.type} programs in "
                f"{model_dir} are missing or incomplete (re-export with "
                f"save_stablehlo=True)")
        self.stablehlo = complete
        tree, artifact = load_inference_params(model_dir)
        state_dict = convert_params(tree)

        if complete:
            if mean_istd_path:
                logger.warning("mean_istd_path is ignored with exported "
                               "programs: their CMVN is part of them")
            self.model = None
            spec = exported_args(exp_off)[0]
            missing = [k for k in spec if k not in state_dict]
            if missing:
                raise KeyError(f"{artifact} lacks the program's inputs "
                               f"{missing[:5]}")
            self.params = {k: state_dict[k].to(self.device, v.dtype)
                           for k, v in spec.items()}
            offline = exp_off.module()
            self._offline = lambda s, l: offline(self.params, s, l)
            if exp_chunk is not None:
                chunk = exp_chunk.module()
                self._chunk = lambda *a: chunk(self.params, *a)
                index = 3 if ds2 else 2
                self._init_state = lambda *_: zero_state_from_exported(
                    exp_chunk, index, self.device)
            logger.info(f"serving the exported programs with {artifact} "
                        f"(no model code)")
        else:
            from ppasr_tpu_torch.models.factory import build_model
            self.model = build_model(
                self.use_model, self.input_dim, self.vocab_size,
                streaming=self.streaming,
                encoder_conf=conf.get('encoder_conf'),
                decoder_conf=conf.get('decoder_conf'),
                model_conf=conf.get('model_conf'),
                mean_istd_path=mean_istd_path)
            self.model.load_state_dict(state_dict, strict=True)
            # frozen, as the programs' weights are: ``F.linear`` of a
            # non-contiguous [B, T, D] input (the Squeezeformer's time
            # reduction) goes through ``torch.matmul``, whose choice between
            # one folded GEMM and a batched one looks at the weight's
            # ``requires_grad``, and the two round differently
            self.model.to(self.device).eval().requires_grad_(False)
            self._offline = self.model.get_encoder_out
            self._chunk = self.model.get_encoder_out_chunk
            if ds2:
                self._init_state = lambda b, *_: self.model.init_state(
                    b, device=self.device)
            else:
                self._init_state = lambda b, cache: self.model.init_state(
                    b, cache, self.device)
        self._state = None

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    # ---------------------------------------------------------------- offline

    @torch.inference_mode()
    @ieee_float32()
    def predict(self, speech: np.ndarray, speech_lens: np.ndarray):
        """[B, T, D] features → ([B, T', V] CTC posteriors, [B] lens), as
        numpy arrays. With the programs, T is padded with zero frames to a
        multiple of 16 of at least 32 (masked by ``speech_lens``), and
        T > ``MAX_FRAMES`` raises."""
        speech = np.asarray(speech, np.float32)
        if self.stablehlo:
            if speech.shape[1] > MAX_FRAMES:
                raise ValueError(
                    f"input of {speech.shape[1]} frames exceeds the exported "
                    f"program's bound ({MAX_FRAMES}); use long-audio "
                    f"segmentation or the model code")
            target = max(32, -(-speech.shape[1] // 16) * 16)
            if speech.shape[1] != target:
                speech = np.pad(speech, ((0, 0), (0, target - speech.shape[1]),
                                         (0, 0)))
        probs, olens = self._offline(self._tensor(speech),
                                     self._tensor(speech_lens, torch.int32))
        return probs.cpu().numpy(), olens.cpu().numpy()

    # -------------------------------------------------------------- streaming

    @torch.inference_mode()
    @ieee_float32()
    def predict_chunk_conformer(self, x_chunk: np.ndarray,
                                required_cache_size: int = 64):
        """[1, T, D] feature chunk → [1, T', V] posteriors; the attention
        and convolution caches stay on the device between calls. The
        chunk program fixes the window and cache sizes at export."""
        if self._state is None:
            self._state = self._init_state(np.shape(x_chunk)[0],
                                           max(required_cache_size, 1))
        probs, self._state = self._chunk(self._tensor(x_chunk), self._state)
        return probs.cpu().numpy()

    @torch.inference_mode()
    @ieee_float32()
    def predict_chunk_deepspeech(self, x_chunk: np.ndarray):
        """[1, T, D] chunk → its posteriors, the RNNs' (h, c) carried."""
        if self._state is None:
            self._state = self._init_state(np.shape(x_chunk)[0])
        lens = torch.full((1,), np.shape(x_chunk)[1], dtype=torch.int32,
                          device=self.device)
        probs, olens, self._state = self._chunk(self._tensor(x_chunk), lens,
                                                self._state)
        return probs[:, :int(olens[0])].cpu().numpy()

    def reset_stream(self):
        """Drop the streaming state."""
        self._state = None
