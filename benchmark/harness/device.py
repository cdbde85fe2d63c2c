"""The card: its name, count, power limit, peaks and memory, and the check
that nothing of JAX or the JAX package is loaded."""
import subprocess
import sys

import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAKS = {'H100': {'fp32_flops': 67e12, 'bytes': 3.35e12}}
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'ppasr_tpu'}


def peaks(kind: str):
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def require_cards(n: int):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} found")


def power_limit() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'not read'


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)


def device_record(chips: int) -> dict:
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips,
            'memory_peak_bytes': max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}
