"""How the port builds a hand-written CUDA kernel: plain ``nvcc`` for
``sm_90a`` into a shared library with a C interface under
``build/torch_kernels/`` (listed in ``.gitignore``), named by the kernel's
stem and a hash of its source and the flags, which the kernel's wrapper
loads with ``ctypes`` at its first call on a CUDA tensor (``fbank_cuda``
for B1, ``ctc_cuda`` for C1)."""
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def find_nvcc() -> str:
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from ppasr_tpu_torch/csrc/")
    return nvcc


def library_path(source: Path, stem: str) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{stem}_{digest}.so'


def build(source: Path, stem: str, force: bool = False) -> Path:
    """Compile ``source`` unless the library for this source exists.
    nvcc's output, with ``-Xptxas -v``'s register and spill report, goes to
    the ``.log`` beside the library. The library is written under a
    temporary name and renamed, so no lock file is needed."""
    so = library_path(source, stem)
    if so.exists() and not force:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix('.log').write_text(
        ' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so
