"""ctypes bindings for the native C++ CTC beam-search decoder (counterpart of
ppasr_tpu/decoders/native.py); this is ``backend: 'native'``, and the
predictor routes an existing ``.klm`` language model here.

The C++ core, ``csrc/ctc_decoder.cpp``, does utterance-parallel offline batch
decoding, stateful streaming decoding and ARPA or ``.klm`` LM fusion. The
port compiles it at first use with ``g++ -O3 -std=c++17 -fPIC -pthread
-shared`` into ``build/torch_kernels/libctc_decoder_<hash of source>.so``
(listed in ``.gitignore``), written under a temporary name and renamed; it
never writes beside the JAX package and never runs ``csrc/Makefile``. A
failed build raises.

Differences from the JAX bindings, on purpose: a language model file that
exists but fails to load raises (the JAX decoder warns and decodes
LM-free); a configured language model that does not exist is named in a
warning before decoding LM-free.
"""
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / 'csrc' / 'ctc_decoder.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
GXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-pthread', '-shared')

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + ' '.join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'libctc_decoder_{digest}.so'


def build() -> Path:
    """Compile ``csrc/ctc_decoder.cpp`` unless the library for this source
    exists; raises when g++ fails or the source is missing."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    cmd = ['g++', *GXX_FLAGS, '-o', str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed with code {proc.returncode} building "
                           f"{SOURCE}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.ctc_decoder_create.restype = ctypes.c_void_p
    lib.ctc_decoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double]
    lib.ctc_decoder_load_lm.restype = ctypes.c_int
    lib.ctc_decoder_load_lm.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.ctc_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.ctc_decoder_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double)]
    lib.ctc_decoder_stream_reset.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ctc_decoder_stream_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int]
    lib.ctc_decoder_stream_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


class NativeBeamSearchDecoder:
    """Decoder with the BeamSearchDecoder surface, running in C++:
    alpha/beta/beam_size/num_processes/cutoff_prob/cutoff_top_n and
    language_model_path (ARPA or ``.klm``)."""

    def __init__(self, vocab_list, alpha: float = 2.2, beta: float = 4.3,
                 beam_size: int = 300, num_processes: int = 10,
                 cutoff_prob: float = 0.99, cutoff_top_n: int = 40,
                 language_model_path: str = None, blank_index: int = 0,
                 **_):
        self._lib = _load()
        self.vocab_list = list(vocab_list)
        self.num_processes = max(1, num_processes)
        self._handle = self._lib.ctc_decoder_create(
            len(vocab_list), blank_index, beam_size, cutoff_top_n,
            cutoff_prob, alpha, beta)
        self._lm_loaded = False
        if language_model_path and os.path.exists(language_model_path):
            joined = '\n'.join(self.vocab_list).encode('utf-8')
            rc = self._lib.ctc_decoder_load_lm(
                self._handle, language_model_path.encode('utf-8'), joined)
            if rc != 0:
                raise RuntimeError(f"the native decoder failed to load the "
                                   f"language model {language_model_path}")
            self._lm_loaded = True
        elif language_model_path:
            logger.warning(f"language model {language_model_path} not "
                           f"found; decoding without it")
        self.reset()

    def __del__(self):
        try:
            if getattr(self, '_handle', None):
                self._lib.ctc_decoder_destroy(self._handle)
        except Exception:
            pass

    def _to_text(self, ids):
        return ''.join(self.vocab_list[i] for i in ids)

    # ------------------------------------------------------------- offline

    def decode_batch(self, probs_batch, lens):
        probs = np.ascontiguousarray(np.asarray(probs_batch), np.float32)
        bsz, t_max, vocab = probs.shape
        lens_arr = np.ascontiguousarray(np.asarray(lens), np.int32)
        max_out = t_max
        out_tokens = np.zeros((bsz, max_out), np.int32)
        out_lens = np.zeros((bsz,), np.int32)
        out_scores = np.zeros((bsz,), np.float64)
        self._lib.ctc_decoder_decode_batch(
            self._handle,
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            bsz, t_max, vocab,
            lens_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            self.num_processes, max_out,
            out_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return [(float(out_scores[b]),
                 self._to_text(out_tokens[b, :out_lens[b]]))
                for b in range(bsz)]

    def decode(self, probs):
        probs = np.asarray(probs)
        return self.decode_batch(probs[None], [probs.shape[0]])[0]

    # ------------------------------------------------------------ streaming

    def reset(self, num_streams: int = 1):
        self._lib.ctc_decoder_stream_reset(self._handle, num_streams)

    def decode_chunk(self, chunk_probs, stream_idx: int = 0):
        probs = np.ascontiguousarray(np.asarray(chunk_probs), np.float32)
        if probs.size:
            self._lib.ctc_decoder_stream_next(
                self._handle, stream_idx,
                probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                probs.shape[0], probs.shape[1])
        return self.current(stream_idx)

    def current(self, stream_idx: int = 0):
        max_out = 4096
        out_tokens = np.zeros((max_out,), np.int32)
        out_len = ctypes.c_int(0)
        out_score = ctypes.c_double(0.0)
        self._lib.ctc_decoder_stream_decode(
            self._handle, stream_idx, max_out,
            out_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ctypes.byref(out_len), ctypes.byref(out_score))
        return float(out_score.value), \
            self._to_text(out_tokens[:out_len.value])
