"""Tensor parallelism on the card (the ``gpu`` marker; each test skips
itself without a card). No JAX here:

    python -m pytest --noconftest -m gpu tests/test_torch_tensor_parallel_cuda.py

Four gloo ranks, all on cuda:0 (more ranks than cards: gloo), under
``torch.distributed.run`` (tests/torch_tp_worker.py):

- JAX's tiny Conformer at DP2×TP2 against one process on the card: losses
  and gradient norms within 1e-5 relative, the whole parameters after 2
  updates within 1e-5;
- kernel B1 inside a DP2×TP2 step: the streaming Conformer on raw audio
  with dither and dropout, through B1 (one launch per micro-batch and rank)
  and again through its plain version (``fbank_batch_torch``) with the
  same random streams: losses within 1e-3 relative (B1 against its plain
  version is a log-mel within ``chip_smoke.MEAN_TOL``/``MAX_TOL``, as in
  tests/test_torch_fbank_cuda.py), replicated parameters bit-equal across
  each model group in both runs.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_worker as w  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
B1_LOSS_RTOL = 1e-3
TIMEOUT = 600


def _card():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 and the card's ranks need a card")


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{'kernel': out dir, 'plain': out dir} of the two launches."""
    _card()
    out = {}
    for name, plain in (('kernel', False), ('plain', True)):
        out[name] = str(tmp_path_factory.mktemp(name))
        train = [['conformer_raw', 2, 2]]
        if not plain:
            train.insert(0, ['conformer', 2, 2])
        w.finish(w.start({'out': out[name], 'device': 'cuda:0',
                          'train': train, 'plain_fbank': plain}), TIMEOUT)
    return out


@pytest.mark.gpu
def test_dp2_tp2_on_the_card_matches_one_process(runs):
    reps = w.reports(runs['kernel'], 'conformer_2x2')
    params = np.load(os.path.join(runs['kernel'],
                                  'conformer_2x2.rank0.params.npz'))
    one, whole = w.train('conformer', 'cuda:0')
    for r in reps:
        assert r['losses'] == reps[0]['losses'] and r['ddp']
    np.testing.assert_allclose(reps[0]['losses'], one['losses'],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(reps[0]['grad_norms'], one['grad_norms'],
                               rtol=LOSS_RTOL)
    for k, v in whole.items():
        np.testing.assert_allclose(params[k], v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.gpu
def test_b1_inside_a_tp2_step_matches_its_plain_version(runs):
    kernel = w.reports(runs['kernel'], 'conformer_raw_2x2')
    plain = w.reports(runs['plain'], 'conformer_raw_2x2')
    assert all(r['launches'] == w.UPDATES * w.ACCUM for r in kernel)
    assert all(r['launches'] == 0 for r in plain)
    np.testing.assert_allclose(kernel[0]['losses'], plain[0]['losses'],
                               rtol=B1_LOSS_RTOL)
    for reps in (kernel, plain):
        assert all(r['losses'] == reps[0]['losses'] for r in reps)
        assert np.isfinite(reps[0]['losses']).all()
        by = {(r['data_index'], r['model_index']): r for r in reps}
        for d in (0, 1):
            assert by[d, 0]['replicated'] == by[d, 1]['replicated']
        for m in (0, 1):
            assert by[0, m]['sharded'] == by[1, m]['sharded']
