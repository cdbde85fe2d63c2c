"""Port parity of the error rates: ``cer`` and ``wer`` of the port (edit
distance in plain Python) against the JAX package's (the ``Levenshtein``
package), on generated strings, empty ones and ones with spaces among
them. Equal, not close: both divide the same integer distance by the same
length."""
import Levenshtein
from hypothesis import given, settings
from hypothesis import strategies as st

from ppasr_tpu.utils import metrics as jax_metrics
from ppasr_tpu_torch.utils import metrics

TEXT = st.text(alphabet='ab cd消耗创建 ', max_size=24)


@settings(max_examples=300, deadline=None)
@given(TEXT, TEXT)
def test_cer_and_wer_equal_jax(hyp, ref):
    assert metrics.cer(hyp, ref) == jax_metrics.cer(hyp, ref)
    assert metrics.wer(hyp, ref) == jax_metrics.wer(hyp, ref)


def test_edge_cases_equal_jax():
    for hyp, ref in (('', ''), ('a', ''), ('', 'a b'), (' ', ' '),
                     ('消耗 创建', '消耗创建'), ('a b c', 'c b a')):
        assert metrics.cer(hyp, ref) == jax_metrics.cer(hyp, ref)
        assert metrics.wer(hyp, ref) == jax_metrics.wer(hyp, ref)


@given(st.text(max_size=12), st.text(max_size=12))
def test_edit_distance_is_levenshtein(a, b):
    assert metrics.edit_distance(a, b) == Levenshtein.distance(a, b)
