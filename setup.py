"""Package setup for ppasr_tpu (parity with reference setup.py packaging)."""
import io
import os

from setuptools import find_packages, setup


def read_version():
    here = os.path.dirname(os.path.abspath(__file__))
    with io.open(os.path.join(here, 'ppasr_tpu', '__init__.py'),
                 encoding='utf-8') as f:
        for line in f:
            if line.startswith('__version__'):
                return line.split('=')[1].strip().strip('"\'')
    return '0.0.0'


setup(
    name='ppasr_tpu',
    version=read_version(),
    description=('TPU-native (JAX/XLA) streaming and offline speech '
                 'recognition framework: Conformer / Squeezeformer / '
                 'EfficientConformer / DeepSpeech2 with CTC greedy and '
                 'on-device prefix beam-search decoding'),
    author='ppasr_tpu contributors',
    license='Apache License 2.0',
    packages=find_packages(include=['ppasr_tpu', 'ppasr_tpu.*',
                                    'ppasr_tpu_torch', 'ppasr_tpu_torch.*']),
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'numpy', 'scipy', 'pyyaml',
        'python-Levenshtein', 'websockets', 'tensorboardX',
    ],
    classifiers=[
        'Programming Language :: Python :: 3',
        'Topic :: Multimedia :: Sound/Audio :: Speech',
    ],
)
