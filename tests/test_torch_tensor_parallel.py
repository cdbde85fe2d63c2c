"""The model axis of the port (ppasr_tpu_torch/parallel/{mesh,
tensor_parallel,distributed}.py, the tensor-parallel paths of the models
and of train_state) against one process of the port and against the JAX
package (ppasr_tpu/parallel/mesh.py, tests/test_sharded_training.py,
tests/test_sharded_decode.py), on the CPU.

One launch of four gloo processes (tests/torch_tp_worker.py under
``torch.distributed.run``, started when the module starts and read by the
tests that need it) makes the grids DP2×TP2, DP1×TP4 and DP4 from one
process group and runs every multi-process case:

- placement: ``param_specs`` equals JAX's ``param_shardings(make_mesh(1,
  n), variables, tp=True)`` leaf for leaf at n_model 2 and 4 for the four
  families at their config widths (the flagship's configs/campaign/
  conformer_synth.yml, configs/{squeezeformer,efficient_conformer,
  deepspeech2}.yml; JAX's shapes from ``jax.eval_shape`` of the init),
  and ``shard_params``/``unshard_params`` round-trip bit-exactly;
- the train step: JAX's tiny Conformer (``torch_tp_worker.CASES``) at
  DP2×TP2 and DP1×TP4, 2 updates of accum_grad 2 by SGD with momentum at
  lr 0.05 (``torch_ddp_worker.PARITY_OPTIMIZER``): losses and gradient
  norms within 1e-5 relative of one process of the port, the whole
  parameters after the updates within 1e-5 (they move far more); within
  1e-3 relative of JAX's single-device step (``value_and_grad`` jitted,
  optax's chain), each tensor's change within 1e-3 of JAX's change (plus
  ``CHANGE_FLOOR``); the EfficientConformer with a BatchNorm conv module
  at DP2×TP2 against one process (the moments over the data group);
- raw audio through the device frontend (B1's plain version here) with
  dither, dropout and the dynamic chunk at DP2×TP2: replicated parameters
  bit-equal across each model group, sharded ones across each data group,
  the sharded regions' dropout seeds different between model peers and
  the replicated regions' the same;
- the batch-sharded beam decode over DP4: JAX's peaky posteriors (8 × 60
  × 128), from probabilities and from logits, texts equal to the unsharded
  ``TorchBeamSearchDecoder`` and scores within ``BEAM_SCORE_TOL``; the
  tiny encoder → decode chain, texts equal to JAX's
  ``JaxBeamSearchDecoder`` on the same posteriors.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_tp_worker as w
from make_torch_smoke_fixture import BEAM_SCORE_TOL
from ppasr_tpu.decoders.beam_search_jax import JaxBeamSearchDecoder
from ppasr_tpu.models.factory import build_model as jax_build_model
from ppasr_tpu.optimizer.factory import build_optimizer as jax_optimizer
from ppasr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ppasr_tpu.parallel.mesh import param_shardings
from ppasr_tpu_torch.config import load_config
from ppasr_tpu_torch.decoders.beam_search_torch import TorchBeamSearchDecoder
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.parallel.mesh import (param_specs, shard_params,
                                           unshard_params)
from ppasr_tpu_torch.train_state import micro_rngs
from ppasr_tpu_torch.utils.checkpoint import convert_params, export_params
from torch_train_util import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-5      # the grid against one process
PARAM_ATOL = 1e-5
JAX_RTOL = 1e-3       # PERF.md §2, float32 training parity
# the norm of a tensor's change that float noise alone makes where the
# gradient is 0 by construction (an attention key's bias under the
# softmax), as in tests/test_torch_ddp.py
CHANGE_FLOOR = 1e-7
TIMEOUT = 300
FAMILIES = {'conformer': 'campaign/conformer_synth.yml',
            'squeezeformer': 'squeezeformer.yml',
            'efficient_conformer': 'efficient_conformer.yml',
            'deepspeech2': 'deepspeech2.yml'}
TRAIN = [('conformer', 2, 2), ('conformer', 1, 4),
         ('efficient_conformer_bn', 2, 2), ('conformer_raw', 2, 2)]
DECODE = ['peaky', 'chain']


@pytest.fixture(scope='module', autouse=True)
def worker(tmp_path_factory):
    """The four ranks, started before the first test (they run while the
    JAX-only tests do); ``tp`` waits for them."""
    out = str(tmp_path_factory.mktemp('tp'))
    proc = w.start({'out': out, 'device': 'cpu',
                    'train': [list(c) for c in TRAIN], 'decode': DECODE})
    yield out, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope='module')
def tp(worker):
    out, proc = worker
    w.finish(proc, TIMEOUT)
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope='module', params=sorted(FAMILIES))
def family(request):
    """(name, the port's flax tree at config width, JAX's variable shapes
    from ``eval_shape`` of its init)."""
    name = request.param
    conf = load_config(os.path.join(w.ROOT, 'configs', FAMILIES[name]))
    confs = dict(encoder_conf=dict(conf.get('encoder_conf') or {}),
                 decoder_conf=dict(conf.get('decoder_conf') or {}),
                 model_conf=dict(conf.get('model_conf') or {}))
    vocab = len(w.vocabulary())
    tree = export_params(build_model(name, 80, vocab, streaming=True,
                                     **confs))
    jm = jax_build_model(name, 80, vocab, streaming=True, **confs)
    x, lens = jnp.zeros((1, 64, 80)), jnp.array([64])
    text, text_lens = jnp.array([[1, 2]], jnp.int32), jnp.array([2])
    shapes = jax.eval_shape(lambda k: jm.init(
        {'params': k, 'dropout': k, 'chunk': k}, x, lens, text, text_lens,
        deterministic=True), jax.random.PRNGKey(0))
    return name, tree, _plain(shapes)


def _plain(tree):
    """A flax variables mapping (a dict or a FrozenDict) as nested dicts."""
    if hasattr(tree, 'items'):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize('n_model', [2, 4])
def test_param_specs_match_jax(family, n_model):
    name, tree, shapes = family
    want = {path: s for path, s in _flat(shapes)}
    got = dict(_flat(tree))
    assert set(got) == set(want), name
    assert all(got[k].shape == tuple(want[k].shape) for k in got), name
    shardings = param_shardings(jax_make_mesh(1, n_model), shapes, tp=True)
    specs = dict(_flat(param_specs(tree, n_model)))
    sharded = 0
    for path, s in _flat(jax.tree_util.tree_map(
            lambda sh: tuple(sh.spec), shardings,
            is_leaf=lambda x: hasattr(x, 'spec'))):
        jax_dim = s.index('model') if 'model' in s else None
        assert specs[path] == jax_dim, (name, path, s)
        sharded += jax_dim is not None
    assert sharded > len(specs) // 4, (name, sharded)


def test_shard_params_round_trip(family):
    name, filled, _ = family      # the port's fresh weights
    for n in (2, 4):
        specs = param_specs(filled, n)
        shards = [shard_params(filled, n, i) for i in range(n)]
        back = dict(_flat(unshard_params(shards, specs)))
        for path, leaf in _flat(filled):
            np.testing.assert_array_equal(back[path], leaf,
                                          err_msg=str(path))
        # the GLU input holds the rank's slice of each half
        for path, dim in _flat(specs):
            if path[-2] == 'pointwise_conv1' and path[-1] == 'kernel':
                whole = dict(_flat(filled))[path]
                a, b = np.split(whole, 2, axis=-1)
                want = np.concatenate([np.split(a, n, -1)[1],
                                       np.split(b, n, -1)[1]], -1)
                np.testing.assert_array_equal(
                    dict(_flat(shards[1]))[path], want)


def test_model_index_folds_into_sharded_dropout_only():
    """Model peers draw the same replicated dropout and dither and their
    own sharded dropout; data peers differ in both."""
    def draws(rank, model_rank):
        rngs = micro_rngs(7, 1, 'cpu', frontend=True, rank=rank,
                          model_rank=model_rank)
        return {k: torch.randint(0, 1 << 30, (4,), generator=g).tolist()
                for k, g in rngs.items()}
    a, b, c = draws(0, 0), draws(0, 1), draws(1, 0)
    assert a['dropout'] == b['dropout'] != c['dropout']
    assert a['frontend'] == b['frontend'] != c['frontend']
    assert a['chunk'] == b['chunk'] == c['chunk']
    assert len({str(a['dropout_sharded']), str(b['dropout_sharded']),
                str(c['dropout_sharded']), str(a['dropout'])}) == 4
    assert 'dropout_sharded' not in micro_rngs(7, 1, 'cpu', rank=0)


@pytest.fixture(scope='module')
def one_process():
    """Each feature case's report and whole parameters in this process."""
    return {case: w.train(case, 'cpu')
            for case in ('conformer', 'efficient_conformer_bn')}


def _grid(tp, case, n_data, n_model):
    """(the ranks' reports, the whole parameters rank 0 gathered)."""
    name = f'{case}_{n_data}x{n_model}'
    params = np.load(os.path.join(tp, f'{name}.rank0.params.npz'))
    return w.reports(tp, name), {k: params[k] for k in params.files}


@pytest.mark.parametrize('case,n_data,n_model', TRAIN[:3])
def test_grid_matches_one_process(tp, one_process, case, n_data, n_model):
    reps, whole = _grid(tp, case, n_data, n_model)
    one, one_whole = one_process[case]
    for r in reps:
        assert r['losses'] == reps[0]['losses']
        assert r['grad_norms'] == reps[0]['grad_norms']
        assert r['replicated'] == reps[0]['replicated']
        assert r['n_sharded'] > 0 and r['ddp'] == (n_data > 1)
    np.testing.assert_allclose(reps[0]['losses'], one['losses'],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(reps[0]['grad_norms'], one['grad_norms'],
                               rtol=LOSS_RTOL)
    start = convert_params(export_params(w.build(case, 'cpu')))
    moved = max(float((one_whole[k] - v).abs().max())
                for k, v in start.items())
    assert moved > 100 * PARAM_ATOL, moved
    assert set(whole) == set(one_whole)
    for k, v in one_whole.items():
        np.testing.assert_allclose(whole[k], v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.fixture(scope='module')
def jax_updates():
    """JAX's single-device step on the tiny Conformer's batches from the
    port's initial weights → (losses, gradient norms, initial and final
    parameters by torch name)."""
    c = w.CASES['conformer']
    jm = jax_build_model('conformer', w.DIM, w.VOCAB, streaming=False,
                         encoder_conf=dict(c['encoder_conf']),
                         decoder_conf=dict(c['decoder_conf']),
                         model_conf=dict(w.MODEL_CONF))
    initial = export_params(w.build('conformer', 'cpu'))
    params = initial['params']

    def loss(p, x, xl, t, tl):
        return jm.apply({'params': p}, x, xl, t, tl, deterministic=True)[
            'loss']

    grad_fn = jax.jit(jax.value_and_grad(loss))
    tx, _ = jax_optimizer(w.PARITY_OPTIMIZER, grad_clip=w.GRAD_CLIP)

    @jax.jit
    def update(g, opt, p):
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt

    opt, losses, norms = tx.init(params), [], []
    for batch in w.batches('conformer', 'cpu'):
        arrays = [jnp.asarray(batch[k].numpy()) for k in
                  ('speech', 'speech_lens', 'text', 'text_lens')]
        terms = [grad_fn(params, *(a[i] for a in arrays))
                 for i in range(w.ACCUM)]
        grads = jax.tree.map(lambda *g: sum(g) / w.ACCUM,
                             *(g for _, g in terms))
        losses.append(float(np.mean([float(v) for v, _ in terms])))
        norms.append(float(optax.global_norm(grads)))
        params, opt = update(grads, opt, params)
    return losses, norms, convert_params(initial['params']), \
        convert_params(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize('n_data,n_model', [(2, 2), (1, 4)])
def test_grid_matches_jax(tp, jax_updates, n_data, n_model):
    reps, whole = _grid(tp, 'conformer', n_data, n_model)
    losses, norms, start, want = jax_updates
    np.testing.assert_allclose(reps[0]['losses'], losses, rtol=JAX_RTOL)
    np.testing.assert_allclose(reps[0]['grad_norms'], norms, rtol=JAX_RTOL)
    for k, p0 in start.items():
        change = float(np.linalg.norm(want[k] - p0))
        err = float(np.linalg.norm(whole[k] - want[k].numpy()))
        assert err <= JAX_RTOL * change + CHANGE_FLOOR, (k, err, change)


def test_dropout_keeps_replicas_equal(tp):
    reps = w.reports(tp, 'conformer_raw_2x2')
    assert np.isfinite([r['losses'] for r in reps]).all()
    assert all(r['losses'] == reps[0]['losses'] for r in reps)
    by = {(r['data_index'], r['model_index']): r for r in reps}
    for d in (0, 1):      # a model group: one data index
        assert by[d, 0]['replicated'] == by[d, 1]['replicated']
        for s0, s1 in zip(by[d, 0]['seeds'], by[d, 1]['seeds']):
            assert s0['dropout'] == s1['dropout']
            assert s0['frontend'] == s1['frontend']
            assert s0['dropout_sharded'] != s1['dropout_sharded']
    for m in (0, 1):      # a data group: one model index
        assert by[0, m]['sharded'] == by[1, m]['sharded']
        for s0, s1 in zip(by[0, m]['seeds'], by[1, m]['seeds']):
            assert s0['dropout'] != s1['dropout']
            assert s0['frontend'] != s1['frontend']
            assert s0['chunk'] == s1['chunk']
    assert by[0, 0]['sharded'] != by[0, 1]['sharded']
    assert len(reps[0]['seeds']) == w.UPDATES * w.ACCUM


@pytest.fixture(scope='module')
def decoded(tp):
    reps = w.reports(tp, 'decode')
    assert all(r == reps[0] for r in reps)
    return reps[0]


@pytest.mark.parametrize('from_logits', [False, True])
def test_sharded_decode_matches_unsharded(decoded, from_logits):
    dec, probs, logits, lens = w.decode_inputs('peaky', 'cpu')
    want = dec.decode_batch_from_logits(logits, lens) if from_logits \
        else dec.decode_batch(probs, lens)
    got = decoded['peaky']['from_logits' if from_logits else 'results']
    assert len(got) == w.PEAKY['bsz']
    assert [t for _, t in got] == [t for _, t in want]
    assert all(t for _, t in got)
    for (s, _), (s_want, _) in zip(got, want):
        assert abs(s - s_want) <= BEAM_SCORE_TOL


def test_encoder_decode_chain_matches_jax(tp, decoded):
    probs = np.concatenate([np.load(os.path.join(
        tp, f'decode_chain.rank{r}.npy')) for r in range(4)])
    lens = np.full((len(probs),), probs.shape[1], np.int32)
    vocab = [str(i) for i in range(w.CHAIN['vocab'])]
    want = JaxBeamSearchDecoder(vocab, beam_size=w.CHAIN['beam_size']
                                ).decode_batch(jnp.asarray(probs), lens)
    for key in ('results', 'from_logits'):
        got = decoded['chain'][key]
        assert [t for _, t in got] == [t for _, t in want], key
    ref = TorchBeamSearchDecoder(vocab, beam_size=w.CHAIN['beam_size'],
                                 device='cpu').decode_batch(probs, lens)
    for (s, _), (s_ref, _) in zip(decoded['chain']['results'], ref):
        assert abs(s - s_ref) <= BEAM_SCORE_TOL
