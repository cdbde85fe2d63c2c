"""Manifest (JSON-lines dataset list) utilities (counterpart of
ppasr_tpu/data/manifest.py; the functions from ``is_ustr`` on are copies of
its :69-258):

- ``read_manifest`` with its duration filter, and ``expand_workspace``,
  which expands a leading ``${WORK}`` in an audio path to the training
  workspace ($PPASR_WORK, by default ``work`` under the home directory);
- ``create_manifest``: an annotation directory of ``path\ttext`` lists →
  duration-sorted train and test manifests (``test.txt`` and every 500th
  line of the others go to test), the text lower-cased, converted to
  simplified Chinese when ``zhconv`` is installed (it is not on either
  machine, and both packages then pass the text through) and, with
  ``only_keep_zh_en``, filtered by ``is_ustr``; audio at another rate is
  resampled in place (``change_rate``);
- ``create_noise``, ``count_manifest`` (the vocabulary's counts),
  ``create_manifest_binary`` (``data/binary``), ``merge_audio`` and
  ``buf_to_float``.
"""
import json
import os

import numpy as np

from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.data.binary import DatasetWriter
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)

try:
    from zhconv import convert as _zh_convert
except ImportError:  # zhconv absent: the text passes through
    def _zh_convert(text, _variant):
        return text

_WORK_PLACEHOLDER = '${WORK}'


def workspace_root() -> str:
    return os.environ.get('PPASR_WORK',
                          os.path.join(os.path.expanduser('~'), 'work'))


def expand_workspace(path: str) -> str:
    """Expand a leading ${WORK} placeholder in a manifest audio path."""
    if path.startswith(_WORK_PLACEHOLDER):
        return workspace_root() + path[len(_WORK_PLACEHOLDER):]
    return path


def read_manifest(manifest_path, max_duration=float('inf'), min_duration=0.5):
    """JSON-lines manifest → list of dicts whose ``duration`` lies in
    [min_duration, max_duration]."""
    manifest = []
    with open(manifest_path, 'r', encoding='utf-8') as f:
        for json_line in f:
            if not json_line.strip():
                continue
            try:
                json_data = json.loads(json_line)
            except json.JSONDecodeError as e:
                raise IOError(f"Error reading manifest: {e}") from e
            if 'audio_filepath' in json_data:
                json_data['audio_filepath'] = expand_workspace(
                    json_data['audio_filepath'])
            if max_duration >= json_data["duration"] >= min_duration:
                manifest.append(json_data)
    return manifest


def is_ustr(text: str) -> str:
    """Keep only CJK unified ideographs and ASCII alphanumerics/space
    (reference utils.py:225-246 char filter)."""
    out = []
    for ch in text:
        if '一' <= ch <= '龥' or ch.isalnum() or ch == ' ':
            out.append(ch)
    return ''.join(out)


def create_manifest(annotation_path: str,
                    train_manifest_path: str,
                    test_manifest_path: str,
                    is_change_frame_rate: bool = True,
                    target_sr: int = 16000,
                    max_test_manifest: int = 10000,
                    only_keep_zh_en: bool = True):
    """annotation dir (tab-separated ``path\ttext`` files) → duration-sorted
    train/test manifests; every 500th line of non-test files goes to test
    (reference utils.py:48-144)."""
    train_list, test_list = [], []
    duration_sum = 0.0
    for annotation_text in os.listdir(annotation_path):
        annotation_file = os.path.join(annotation_path, annotation_text)
        if not annotation_file.endswith('.txt'):
            continue
        with open(annotation_file, 'r', encoding='utf-8') as f:
            lines = f.readlines()
        is_test_file = annotation_text == 'test.txt'
        for i, line in enumerate(lines):
            parts = line.strip().split('\t')
            if len(parts) != 2:
                continue
            audio_path, text = parts
            if not os.path.exists(audio_path):
                continue
            try:
                audio = AudioSegment.from_file(audio_path)
            except Exception as e:
                logger.warning(f"skip {audio_path}: {e}")
                continue
            if is_change_frame_rate and audio.sample_rate != target_sr:
                change_rate(audio_path, target_sr)
                audio = AudioSegment.from_file(audio_path)
            duration = audio.duration
            duration_sum += duration
            text = _zh_convert(text.lower(), 'zh-cn')
            if only_keep_zh_en:
                text = is_ustr(text)
            if not text:
                continue
            entry = json.dumps({'audio_filepath': audio_path.replace('\\', '/'),
                                'duration': round(duration, 2),
                                'text': text}, ensure_ascii=False)
            if is_test_file or (i % 500 == 0 and i != 0
                                and len(test_list) < max_test_manifest):
                test_list.append((duration, entry))
            else:
                train_list.append((duration, entry))

    for path, entries in [(train_manifest_path, train_list),
                          (test_manifest_path, test_list)]:
        entries.sort(key=lambda x: x[0])  # sortagrad epoch-0 ordering
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        with open(path, 'w', encoding='utf-8') as f:
            for _, e in entries:
                f.write(e + '\n')
    logger.info(f"created manifests: {len(train_list)} train / "
                f"{len(test_list)} test, {duration_sum / 3600:.2f} h total")


def change_rate(audio_path: str, target_sr: int = 16000):
    """Resample a wav file in place (reference utils.py:208-222)."""
    audio = AudioSegment.from_file(audio_path)
    audio.resample(target_sr)
    audio.to_wav_file(audio_path)


def create_noise(path: str, noise_manifest_path: str,
                 is_change_frame_rate: bool = True, target_sr: int = 16000):
    """Directory of noise wavs → noise manifest (reference utils.py:250-278)."""
    if not os.path.exists(path):
        logger.warning(f"noise dir missing: {path}")
        return
    json_lines = []
    for file in sorted(os.listdir(path)):
        audio_path = os.path.join(path, file)
        try:
            audio = AudioSegment.from_file(audio_path)
        except Exception:
            continue
        if is_change_frame_rate and audio.sample_rate != target_sr:
            change_rate(audio_path, target_sr)
            audio = AudioSegment.from_file(audio_path)
        json_lines.append(json.dumps(
            {'audio_filepath': audio_path.replace('\\', '/'),
             'duration': round(audio.duration, 2), 'text': ''},
            ensure_ascii=False))
    os.makedirs(os.path.dirname(noise_manifest_path) or '.', exist_ok=True)
    with open(noise_manifest_path, 'w', encoding='utf-8') as f:
        for line in json_lines:
            f.write(line + '\n')


def count_manifest(counter, manifest_path: str):
    """Accumulate char counts for vocab creation (reference utils.py:282-293)."""
    for entry in read_manifest(manifest_path):
        for char in entry['text'].replace('\n', ''):
            counter.update(char)


def create_manifest_binary(train_manifest_path: str, test_manifest_path: str):
    """txt manifests → binary record stores (reference utils.py:296-310)."""
    for manifest_path in [train_manifest_path, test_manifest_path]:
        dataset_writer = DatasetWriter(manifest_path)
        with open(manifest_path, 'r', encoding='utf-8') as f:
            for line in f:
                if line.strip():
                    dataset_writer.add_data(line.strip())
        dataset_writer.close()


def merge_audio(annotation_path: str, save_audio_path: str,
                max_duration: float = 600.0, target_sr: int = 16000):
    """Pack short wavs into ≤max_duration-second files; entries carry
    start_time/end_time into the packed file (reference utils.py:148-204).
    Rewrites each annotation list with a .merged suffix."""
    os.makedirs(save_audio_path, exist_ok=True)
    for annotation_file in sorted(os.listdir(annotation_path)):
        if not annotation_file.endswith('.txt'):
            continue
        in_path = os.path.join(annotation_path, annotation_file)
        out_path = in_path + '.merged.jsonl'
        merged_samples = []
        merged_duration = 0.0
        file_idx = 0
        entries = []

        def flush():
            nonlocal merged_samples, merged_duration, file_idx
            if not merged_samples:
                return None
            out_wav = os.path.join(
                save_audio_path,
                f"{os.path.splitext(annotation_file)[0]}_{file_idx}.wav")
            seg = AudioSegment(np.concatenate(merged_samples), target_sr)
            seg.to_wav_file(out_wav)
            merged_samples = []
            merged_duration = 0.0
            file_idx += 1
            return out_wav

        pending = []
        with open(in_path, 'r', encoding='utf-8') as f:
            for line in f:
                parts = line.strip().split('\t')
                if len(parts) != 2 or not os.path.exists(parts[0]):
                    continue
                audio = AudioSegment.from_file(parts[0])
                if audio.sample_rate != target_sr:
                    audio.resample(target_sr)
                start = merged_duration
                merged_samples.append(audio.samples)
                merged_duration += audio.duration
                pending.append({'start_time': round(start, 3),
                                'end_time': round(merged_duration, 3),
                                'text': parts[1],
                                'duration': round(audio.duration, 3)})
                if merged_duration >= max_duration:
                    out_wav = flush()
                    for e in pending:
                        e['audio_filepath'] = out_wav
                        entries.append(e)
                    pending = []
        out_wav = flush()
        for e in pending:
            e['audio_filepath'] = out_wav
            entries.append(e)
        with open(out_path, 'w', encoding='utf-8') as f:
            for e in entries:
                f.write(json.dumps(e, ensure_ascii=False) + '\n')
        logger.info(f"merged {len(entries)} utterances from "
                    f"{annotation_file} → {out_path}")


def buf_to_float(buf: bytes, n_bytes: int = 2) -> np.ndarray:
    """PCM byte buffer → float32 [-1, 1] (reference utils.py:381-407)."""
    scale = 1.0 / float(1 << ((8 * n_bytes) - 1))
    fmt = f'<i{n_bytes}'
    return scale * np.frombuffer(buf, fmt).astype(np.float32)
