"""Port parity of punctuation restoration on the CPU: the JAX
``PunctuationPredictor`` (ppasr_tpu/infer_utils/pun_predictor.py) and the
port's, both from the artifact committed as ppasr_tpu/assets/pun_models.
Label ids per character must be equal, and so the punctuated texts;
the classifier's logits within 1e-4 (float32 over 3 blocks, sums in other
orders)."""
import numpy as np
import pytest
import torch

from ppasr_tpu.infer_utils.pun_predictor import \
    PunctuationPredictor as JaxPunctuation
from ppasr_tpu_torch.infer_utils import pun_predictor as port_pun

TEXTS = ['今天天气很好我们去公园玩太好了', '他在看书你吃饭了吗明天见',
         '近几年不但我用书给女儿压岁也劝说亲朋不要给女儿压岁钱而改送压岁书',
         '消耗创建具杨树北也可以命', '好']


@pytest.fixture(scope='module')
def predictors():
    return JaxPunctuation(), port_pun.PunctuationPredictor(device='cpu')


def _jax_labels(pred, text):
    ids = np.asarray([[pred.tok_to_id.get(ch, 1) for ch in text]], np.int32)
    return np.asarray(pred._infer(pred.params, ids))[0]


@pytest.mark.parametrize('text', TEXTS)
def test_labels_and_text_equal_jax(predictors, text):
    jax_pred, port_pred = predictors
    np.testing.assert_array_equal(port_pred.labels_of(text),
                                  _jax_labels(jax_pred, text))
    assert port_pred(text) == jax_pred(text)
    assert port_pred('，'.join([text, text])) == jax_pred(
        '，'.join([text, text]))


def test_logits_match_jax(predictors):
    jax_pred, port_pred = predictors
    ids = np.asarray([[jax_pred.tok_to_id.get(ch, 1) for ch in TEXTS[2]]],
                     np.int32)
    want = np.asarray(jax_pred.model.apply(jax_pred.params, ids))
    with torch.no_grad():
        got = port_pred.model(torch.from_numpy(ids).long()).numpy()
    assert np.abs(got - want).max() <= 1e-4
    assert (np.asarray(port_pred.labels_of(TEXTS[2])) > 0).any()


def test_text_longer_than_max_len_goes_in_pieces(predictors):
    port_pred = predictors[1]
    n = port_pred.model.max_len
    text = (TEXTS[2] * 20)[:n + 40]
    labels = port_pred.labels_of(text)
    assert labels.shape == (n + 40,)
    np.testing.assert_array_equal(labels[n:], port_pred.labels_of(text[n:]))


def test_model_dir_falls_back_to_the_artifact_and_bad_files_raise(tmp_path):
    pred = port_pun.PunctuationPredictor(str(tmp_path / 'absent'),
                                         device='cpu')
    assert pred(TEXTS[0]) == port_pun.PunctuationPredictor(device='cpu')(
        TEXTS[0])
    src = port_pun.packaged_pun_model_dir()
    for name in ('pun_vocab.txt', 'pun_labels.txt', 'pun_config.txt'):
        (tmp_path / name).write_bytes(open(f'{src}/{name}', 'rb').read())
    (tmp_path / 'pun_model.msgpack').write_bytes(b'\xc1')
    with pytest.raises(ValueError):
        port_pun.PunctuationPredictor(str(tmp_path), device='cpu')
