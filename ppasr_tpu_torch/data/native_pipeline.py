"""ctypes binding for the native raw-audio loader (counterpart of
ppasr_tpu/data/native_pipeline.py, over the same csrc/audio_pipeline.cpp).

The C++ core runs the host side of device-frontend training on a thread
pool: wav read (or a [start_time, end_time] slice) → noise, speed, shift
and volume augmentation → dB normalization → int16-scaled float samples.

Randomness stays in Python: ``draw_augment_params`` samples the same
distributions as the host ``AugmentationPipeline`` with the ``random``
module, in the same order as the JAX package, and the C++ side applies the
drawn ``ItemParams`` deterministically. An item the core rejects (a wav
that is not PCM, a rate that needs resampling, noise at another rate) comes
back with length −1; the dataset then loads it through its Python item
path.

The port compiles the source at first use with ``g++ -O3 -std=c++17 -fPIC
-pthread -shared`` into ``build/torch_kernels/libaudio_pipeline_<hash of
source>.so`` (listed in ``.gitignore``), written under a temporary name and
renamed; it never writes beside the JAX package and never runs
``csrc/Makefile``. A failed build raises, where the JAX package warns and
loads every item in Python.
"""
import ctypes
import hashlib
import os
import random
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / 'csrc' / 'audio_pipeline.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
GXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-pthread', '-shared')

MAX_NOISE = 2  # overlays per item (augmentation.json's repetition default)
NATIVE_STAGES = ('noise', 'speed', 'shift', 'volume')

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + ' '.join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'libaudio_pipeline_{digest}.so'


def build() -> Path:
    """Compile ``csrc/audio_pipeline.cpp`` unless the library for this
    source exists; raises when g++ fails or the source is missing."""
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


def load():
    """The library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.ap_load_batch.restype = ctypes.c_int
    lib.ap_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,          # paths, n
        ctypes.POINTER(ctypes.c_double),                        # starts
        ctypes.POINTER(ctypes.c_double),                        # ends
        ctypes.POINTER(ctypes.c_char_p),                        # noise paths
        ctypes.POINTER(ctypes.c_double),                        # snr
        ctypes.POINTER(ctypes.c_double),                        # noise offset
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,             # n_noise, max
        ctypes.POINTER(ctypes.c_double),                        # speed
        ctypes.POINTER(ctypes.c_double),                        # shift ms
        ctypes.POINTER(ctypes.c_double),                        # volume dB
        ctypes.c_int, ctypes.c_double, ctypes.c_int,            # rate/db/norm
        ctypes.POINTER(ctypes.c_float),                         # out
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,   # lens, max_s
        ctypes.c_int,                                           # threads
    ]
    _lib = lib
    return lib


class ItemParams:
    """One utterance's augmentation decisions (drawn in Python)."""
    __slots__ = ('noise_paths', 'snr_db', 'noise_offsets', 'speed_rate',
                 'shift_ms', 'volume_gain_db')

    def __init__(self):
        self.noise_paths = []
        self.snr_db = []
        self.noise_offsets = []
        self.speed_rate = 1.0
        self.shift_ms = 0.0
        self.volume_gain_db = 0.0


def draw_augment_params(augmentation) -> ItemParams:
    """One utterance's decisions from the pipeline's audio stages, with the
    draws of ``AugmentationPipeline.transform_audio`` from ``random`` (a
    stage's gate, then its own draws). 'resample' and unknown stages draw
    nothing: ``native_stages_only`` keeps the native path off when one is
    enabled."""
    p = ItemParams()
    if augmentation is None:
        return p
    for aug, prob, name in augmentation._audio_stages:
        if random.random() >= prob:
            continue
        if name == 'noise':
            if not aug.noise_manifest:
                continue
            for _ in range(random.randint(1, aug.repetition)):
                entry = random.choice(aug.noise_manifest)
                snr = random.uniform(aug.min_snr_dB, aug.max_snr_dB)
                if len(p.noise_paths) < MAX_NOISE:
                    p.noise_paths.append(entry['audio_filepath'])
                    p.snr_db.append(snr)
                    p.noise_offsets.append(random.random())
        elif name == 'speed':
            p.speed_rate = float(random.choice(aug._rates))
        elif name == 'shift':
            p.shift_ms = random.uniform(aug.min_shift_ms, aug.max_shift_ms)
        elif name == 'volume':
            p.volume_gain_db = random.uniform(aug.min_gain_dBFS,
                                              aug.max_gain_dBFS)
    return p


def native_stages_only(augmentation) -> bool:
    """True when every enabled audio stage has a native implementation."""
    if augmentation is None:
        return True
    return all(prob <= 0.0 or name in NATIVE_STAGES
               for _, prob, name in augmentation._audio_stages)


def load_raw_batch(entries, params, sample_rate: int, target_db,
                   max_samples: int, n_threads: int = 4):
    """Manifest entries and their ``ItemParams`` → (wavs [n, max_samples]
    float32 int16-scaled, lens [n] int64); ``lens[i] == -1`` marks an item
    the core rejected. ``target_db`` None skips the dB normalization."""
    lib = load()
    n = len(entries)
    paths = (ctypes.c_char_p * n)(*[
        e['audio_filepath'].encode() for e in entries])
    starts = (ctypes.c_double * n)(*[
        float(e.get('start_time', -1.0)) for e in entries])
    ends = (ctypes.c_double * n)(*[
        float(e.get('end_time', -1.0)) for e in entries])
    noise_paths = (ctypes.c_char_p * (n * MAX_NOISE))()
    snr = (ctypes.c_double * (n * MAX_NOISE))()
    noff = (ctypes.c_double * (n * MAX_NOISE))()
    n_noise = (ctypes.c_int * n)()
    speed = (ctypes.c_double * n)()
    shift = (ctypes.c_double * n)()
    vol = (ctypes.c_double * n)()
    for i, pp in enumerate(params):
        n_noise[i] = len(pp.noise_paths)
        for k, (npth, s, off) in enumerate(zip(pp.noise_paths, pp.snr_db,
                                               pp.noise_offsets)):
            noise_paths[i * MAX_NOISE + k] = npth.encode()
            snr[i * MAX_NOISE + k] = s
            noff[i * MAX_NOISE + k] = off
        speed[i] = pp.speed_rate
        shift[i] = pp.shift_ms
        vol[i] = pp.volume_gain_db

    out = np.zeros((n, max_samples), np.float32)
    lens = np.zeros((n,), np.int64)
    rc = lib.ap_load_batch(
        paths, n, starts, ends, noise_paths, snr, noff, n_noise, MAX_NOISE,
        speed, shift, vol, int(sample_rate),
        float(target_db if target_db is not None else 0.0),
        1 if target_db is not None else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        max_samples, int(n_threads))
    if rc != 0:
        raise RuntimeError(f"ap_load_batch failed: {rc}")
    return out, lens
