"""The port's ITN (ppasr_tpu_torch/utils/itn.py) is a copy of
ppasr_tpu/utils/itn.py below the module docstring: the two modules' code
must be equal statement for statement, and their results equal on the JAX
package's ITN cases and on sentences mixing them."""
import ast
import os

import pytest

from ppasr_tpu.utils import itn as jax_itn
from ppasr_tpu_torch.utils import itn as port_itn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _body(path):
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read())
    assert isinstance(tree.body[0].value, ast.Constant)   # the docstring
    return [ast.dump(node) for node in tree.body[1:]]


def test_copy_equals_the_original():
    assert _body(os.path.join(ROOT, 'ppasr_tpu_torch', 'utils', 'itn.py')) \
        == _body(os.path.join(ROOT, 'ppasr_tpu', 'utils', 'itn.py'))


@pytest.mark.parametrize('text', [
    '三百二十五', '一万二千', '两千零一', '十五', '一亿三千万', '二零二五',
    '电话一三八零零', '三点一四', '百分之六十', '百分之三点五', '负五十',
    '他买了三百二十五个苹果', '增长了百分之十五左右', '我们一起走', '万一有事',
    '你好世界', '', '负一点五度，百分之五十，一千零二十四个', '点五'])
def test_results_equal(text):
    assert port_itn.inverse_normalize(text) == \
        jax_itn.inverse_normalize(text)
