"""The port's Python item path under given augmentation decisions (no JAX),
to hold the native raw-audio loader (ppasr_tpu_torch/data/
native_pipeline.py) to the ``AudioSegment`` chain transform by transform,
as tests/test_native_pipeline.py holds the JAX package's: for
tests/test_torch_native_pipeline.py, tests/test_torch_ddp_cuda.py and
chip_smoke.py's ddp phase."""
import wave

import numpy as np

from ppasr_tpu_torch.data import native_pipeline
from ppasr_tpu_torch.data.audio import AudioSegment

SR = 16000
TARGET_DB = -20.0
# |native − Python| in int16 units, tests/test_native_pipeline.py:93-167
TOLERANCES = {'plain': 1.0, 'speed': 1.5, 'shift_volume': 1.5,
              'noise': 2.0}


def write_wav(path, samples_f32, sr=SR):
    pcm = np.clip(samples_f32 * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return str(path)


def write_noise(path, seconds=0.4, seed=7):
    """Gaussian noise shorter than the utterances (the wrap-padded case)."""
    rng = np.random.default_rng(seed)
    return write_wav(path, (rng.standard_normal(int(SR * seconds)) * 0.05)
                     .astype(np.float32))


def item_params(**values):
    p = native_pipeline.ItemParams()
    for k, v in values.items():
        setattr(p, k, v)
    return p


def cases(noise_path):
    """Each transform's decisions: name → [ItemParams]."""
    return {
        'plain': [item_params()],
        'speed': [item_params(speed_rate=r) for r in (0.9, 1.1)],
        'shift_volume': [item_params(shift_ms=3.5, volume_gain_db=6.0),
                         item_params(shift_ms=-2.25, volume_gain_db=-9.0)],
        'noise': [item_params(noise_paths=[noise_path], snr_db=[15.0],
                              noise_offsets=[0.0])],
    }


def python_item(entry, p, target_db=TARGET_DB):
    """The Python chain under ``p``: noise (its cut starting at 0), speed,
    shift, volume, dB normalization → int16-scaled float32 samples."""
    seg = AudioSegment.from_file(entry['audio_filepath'])
    for path, snr in zip(p.noise_paths, p.snr_db):
        noise = AudioSegment.from_file(path)
        if noise.duration < seg.duration:
            reps = int(np.ceil(seg.num_samples / noise.num_samples))
            noise = AudioSegment(
                np.tile(noise.samples, reps)[:seg.num_samples + 1],
                noise.sample_rate)
        gain = min(seg.rms_db - noise.rms_db - snr, 300.0)
        cut = AudioSegment(noise.samples.copy(), noise.sample_rate)
        cut.subsegment(0.0, seg.duration)
        cut.gain_db(gain)
        n = min(seg.num_samples, cut.num_samples)
        mixed = seg.samples
        mixed[:n] += cut.samples[:n]
        seg = AudioSegment(mixed, seg.sample_rate)
    if p.speed_rate != 1.0:
        seg.change_speed(p.speed_rate)
    if p.shift_ms:
        seg.shift(p.shift_ms)
    if p.volume_gain_db:
        seg.gain_db(p.volume_gain_db)
    if target_db is not None:
        seg.normalize(target_db=target_db)
    return seg.to('int16').astype(np.float32)


def native_against_items(entries, noise_path, n_threads=2):
    """name → the largest |native − Python| over ``entries`` under each of
    that transform's decisions; raises where a length differs or the core
    rejects an item."""
    errors = {}
    for name, params in cases(noise_path).items():
        err = 0.0
        for p in params:
            max_s = max(int(e['duration'] * SR / min(p.speed_rate, 1.0))
                        for e in entries) + 512
            wavs, lens = native_pipeline.load_raw_batch(
                entries, [p] * len(entries), SR, TARGET_DB, max_s,
                n_threads=n_threads)
            for j, e in enumerate(entries):
                want = python_item(e, p)
                if lens[j] != len(want):
                    raise AssertionError(f"{name}: {e['audio_filepath']} "
                                         f"{lens[j]} samples, Python "
                                         f"{len(want)}")
                err = max(err, float(np.max(np.abs(
                    wavs[j, :lens[j]] - want))))
        errors[name] = err
    return errors
