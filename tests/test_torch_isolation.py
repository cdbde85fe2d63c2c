"""The port stands alone: ``ppasr_tpu_torch`` and ``chip_smoke.py`` import
none of JAX, flax, the JAX package, msgpack, PyYAML, distutils or
Levenshtein (the card's machine has torch, numpy and scipy, and Python 3.12
has no distutils), the server imports ``websockets`` only when it starts,
and the predictor refuses ``use_gpu=True`` without a card. ``chip_smoke.py``
also imports the fixture helpers in tests/make_torch_smoke_fixture.py,
tests/make_torch_train_fixture.py, tests/make_torch_zoo_fixture.py,
tests/make_torch_recipe_fixture.py, whose JAX imports sit inside
functions, and tests/torch_ddp_worker.py and tests/torch_native_util.py,
which import none; importing them loads none of the above."""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'ppasr_tpu', 'msgpack', 'yaml',
             'distutils', 'Levenshtein')


def _port_sources():
    files = sorted(glob.glob(os.path.join(ROOT, 'ppasr_tpu_torch', '**',
                                          '*.py'), recursive=True))
    return files + [os.path.join(ROOT, 'chip_smoke.py')]


def _imported_roots(path):
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', None)) in (
                'import_module', '__import__') and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split('.')[0]


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_leaves_no_forbidden_module_loaded():
    code = ("import sys, chip_smoke, ppasr_tpu_torch.predict, "
            "ppasr_tpu_torch.ops.fbank_cuda, ppasr_tpu_torch.serving, "
            "ppasr_tpu_torch.models.streaming_eval, "
            "ppasr_tpu_torch.utils.metrics, ppasr_tpu_torch.infer_path, "
            "ppasr_tpu_torch.decoders.lm, ppasr_tpu_torch.decoders.klm, "
            "ppasr_tpu_torch.decoders.beam_search, "
            "ppasr_tpu_torch.decoders.native, "
            "ppasr_tpu_torch.decoders.beam_search_torch, "
            "ppasr_tpu_torch.decoders.rescoring, "
            "ppasr_tpu_torch.models.transformer_decoder, "
            "ppasr_tpu_torch.models.rescore, ppasr_tpu_torch.ops.common, "
            "ppasr_tpu_torch.utils.itn, "
            "ppasr_tpu_torch.infer_utils.pun_predictor, "
            "ppasr_tpu_torch.infer_utils.silero, "
            "ppasr_tpu_torch.infer_utils.vad_predictor, "
            "ppasr_tpu_torch.ops.ctc, ppasr_tpu_torch.ops.label_smoothing, "
            "ppasr_tpu_torch.ops.frontend, ppasr_tpu_torch.ops.masks, "
            "ppasr_tpu_torch.optimizer.scheduler, "
            "ppasr_tpu_torch.optimizer.factory, "
            "ppasr_tpu_torch.train_state, ppasr_tpu_torch.trainer, "
            "ppasr_tpu_torch.train, ppasr_tpu_torch.data.manifest, "
            "ppasr_tpu_torch.data.sampler, ppasr_tpu_torch.data.dataset, "
            "ppasr_tpu_torch.data.loader, "
            "ppasr_tpu_torch.data.augmentor.augmentation, "
            "ppasr_tpu_torch.data.augmentor.audio_augmentors, "
            "ppasr_tpu_torch.data.augmentor.base, "
            "ppasr_tpu_torch.utils.model_summary, "
            "ppasr_tpu_torch.utils.checkpoint, ppasr_tpu_torch.data.binary, "
            "ppasr_tpu_torch.data.normalizer, "
            "ppasr_tpu_torch.data.augmentor.feature_augmentors, "
            "ppasr_tpu_torch.create_data, ppasr_tpu_torch.extract_features, "
            "ppasr_tpu_torch.eval, ppasr_tpu_torch.tune, "
            "ppasr_tpu_torch.export_model, ppasr_tpu_torch.utils.quant, "
            "ppasr_tpu_torch.utils.precision, ppasr_tpu_torch.ops.rnn, "
            "ppasr_tpu_torch.infer_utils.torch_export, "
            "ppasr_tpu_torch.infer_utils.inference_predictor, "
            "ppasr_tpu_torch.infer_server, ppasr_tpu_torch.parallel, "
            "ppasr_tpu_torch.parallel.distributed, "
            "ppasr_tpu_torch.data.native_pipeline;"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('websockets',)!r}))")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]', out.stdout


@pytest.mark.parametrize('module', ['train_state', 'trainer', 'serving',
                                    'models.streaming_eval'])
def test_lower_layers_do_not_load_the_predictor(module):
    """Imports point down: the train step, the trainer, the engine and the
    streaming eval take ``ieee_float32`` from ``utils/precision``, so none
    loads the predictor module."""
    code = (f"import sys, ppasr_tpu_torch.{module}; "
            f"print('ppasr_tpu_torch.predict' in sys.modules)")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'False'


def test_server_imports_websockets_only_when_it_starts():
    """The server imports ``websockets`` inside ``RecognitionServer.start``,
    never at the top, so its HTTP side runs where the package is absent."""
    path = os.path.join(ROOT, 'ppasr_tpu_torch', 'infer_server.py')
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read(), path)
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            top.add(node.module.split('.')[0])
    assert 'websockets' not in top
    assert 'websockets' in set(_imported_roots(path))


def test_use_gpu_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: use_gpu=True is the normal path")
    from ppasr_tpu_torch.predict import PPASRPredictor
    with pytest.raises(RuntimeError, match='cuda'):
        PPASRPredictor(model_path=str(tmp_path), use_gpu=True)
