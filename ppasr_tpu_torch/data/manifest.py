"""Manifest (JSON-lines dataset list) reading (counterpart of
ppasr_tpu/data/manifest.py:27-65): ``read_manifest`` with its duration
filter and ``expand_workspace``, which expands a leading ``${WORK}`` in an
audio path to the training workspace ($PPASR_WORK, by default ``work``
under the home directory). Building manifests (``create_manifest``,
``create_noise``, the binary format) comes with ``create_data`` (ROADMAP
Queue A, item 12)."""
import json
import os

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
