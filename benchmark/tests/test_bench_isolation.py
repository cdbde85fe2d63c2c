"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``ppasr_tpu_torch`` begins with
``ppasr_tpu``); the reference imports nothing of the port either."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX = {'jax', 'jaxlib', 'flax', 'ppasr_tpu'}


def imported(path: Path):
    tree = ast.parse(path.read_text(encoding='utf-8'))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', None)) in (
                'import_module', '__import__') and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split('.')[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(set(imported(p)) & JAX)
             for p in BENCH.rglob('*.py')}
    assert not {k: v for k, v in found.items() if v}
    assert len(found) > 20


def test_reference_imports_nothing_of_the_port():
    ref = list((BENCH / 'reference').rglob('*.py'))
    assert ref
    for p in ref:
        names = set(imported(p))
        assert not names & (JAX | {'ppasr_tpu_torch'}), p
        assert names <= {'math', 'functools', 'numpy', 'torch', 'reference'}, \
            (p, names)


def test_the_check_sees_the_difference():
    assert 'ppasr_tpu' in JAX and 'ppasr_tpu_torch' not in JAX
    assert 'ppasr_tpu_torch'.split('.')[0] != 'ppasr_tpu'
