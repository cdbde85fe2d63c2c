"""The port's training step (ppasr_tpu_torch/train_state.py, models,
optimizer/) against the JAX package's on the CPU at a tiny width (2 encoder
blocks, d 32, decoder 1 + 1 blocks, vocab 12; one encoder block where a
test says so, to spare a JAX compile), with the JAX parameters converted
by ``convert_params``:

- the loss terms and every parameter's gradient against
  ``jax.value_and_grad`` of the JAX model (float32, deterministic): values
  within 1e-5 relative, each gradient within 1e-5 of the largest |gradient|
  of its leaf plus 1e-5 of the largest of all (the sums run in another
  order; a few leaves, such as the attention key biases, have a true
  gradient of 0 and carry rounding only);
- bf16 (``enable_amp``: cast at use over float32 parameters): the loss
  terms within 1e-2 relative, and the gradient as a whole within 5e-2 of
  its norm (‖g_port − g_jax‖ ≤ 0.05·‖g_jax‖); each framework rounds to bf16
  at other places, while the parameters and their gradients stay float32;
- the three schedules against optax's within 1e-6 relative (float32
  arithmetic in both), and the optimizer chain (clip 5 → AdamW, SGD with
  momentum) over 5 updates against optax: parameters within 1e-5 relative
  plus 1e-6 absolute (the same float32 update with its terms in another
  order; Adam's division by √v magnifies rounding where v is small);
- ``accum_grad`` 2 against ``make_train_step`` with dropout off (a
  non-streaming model, so nothing is random) and SGD with momentum, whose
  update is linear in the averaged gradient (Adam's would hide a wrong
  scale): metrics and parameters after 2 updates within 1e-5 relative plus
  1e-6 absolute;
- fresh initialization: each leaf's mean and standard deviation against the
  JAX init's, within 5/√n of the JAX std (sampling error), biases and
  LayerNorms exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ppasr_tpu.models.conformer import ConformerModel as JaxConformer
from ppasr_tpu.optimizer import factory as jax_factory
from ppasr_tpu.optimizer import scheduler as jax_scheduler
from ppasr_tpu.train_state import TrainState as JaxState
from ppasr_tpu.train_state import make_train_step as jax_make_train_step
from ppasr_tpu_torch.models.conformer import ConformerModel
from ppasr_tpu_torch.optimizer import scheduler
from ppasr_tpu_torch.train_state import create_train_state, make_train_step
from ppasr_tpu_torch.utils.checkpoint import convert_params, export_params
from torch_train_util import DEC, ENC, D, V, one_torch_thread  # noqa: F401

NO_DROP = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
               attention_dropout_rate=0.0)
NO_DROP_DEC = dict(dropout_rate=0.0, positional_dropout_rate=0.0)
OPT = {'optimizer': 'Adam', 'weight_decay': 1e-6, 'learning_rate': 1e-3,
       'scheduler': 'WarmupLR',
       'scheduler_conf': {'warmup_steps': 1000, 'min_lr': 1e-5}}


def _cmvn():
    rng = np.random.default_rng(0)
    return (tuple(np.float32(v) for v in rng.normal(size=D)),
            tuple(np.float32(v) for v in rng.uniform(0.5, 1.5, size=D)))


def _jax_model(streaming=True, enc=ENC, dec=DEC, dtype=jnp.float32):
    mean, istd = _cmvn()
    return JaxConformer(input_size=D, vocab_size=V, streaming=streaming,
                        encoder_conf=dict(enc), decoder_conf=dict(dec),
                        cmvn_mean=mean, cmvn_istd=istd, dtype=dtype)


def _pair(streaming=True, enc=ENC, dec=DEC, dtype=jnp.float32, seed=0):
    """(JAX model, its parameters, the port's model with the same values):
    the port draws them (``init_weights``) and ``export_params`` hands them
    to JAX, which saves a flax init per test."""
    mean, istd = _cmvn()
    tm = ConformerModel(D, V, streaming, dict(enc), dict(dec),
                        cmvn_mean=mean, cmvn_istd=istd)
    tm.init_weights(torch.Generator().manual_seed(seed))
    params = export_params(tm)
    tm.load_state_dict(convert_params(params), strict=True)
    return _jax_model(streaming, enc, dec, dtype), params, tm


def _batch(seed=1, b=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 100, D)).astype(np.float32)
    lens = np.array([100, 80, 57, 93][:b])
    text = np.array([[1, 2, 3, 4], [5, 5, -1, -1], [7, -1, -1, -1],
                     [9, 8, 10, -1]][:b], np.int32)
    return x, lens, text, np.array([4, 2, 1, 3][:b])


@pytest.fixture(scope='module', params=['float32', 'bfloat16'])
def grads(request):
    """JAX and port (loss terms, gradients by torch name) on one batch."""
    bf16 = request.param == 'bfloat16'
    # bf16 at one encoder block: another compile of the whole model costs
    # what a block adds, and the casts are the same in every block
    jm, params, tm = _pair(enc=dict(ENC, num_blocks=1) if bf16 else ENC,
                           dtype=jnp.bfloat16 if bf16 else jnp.float32)
    x, lens, text, tl = _batch()
    args = [jnp.asarray(a) for a in (x, lens, text, tl)]

    def f(p):
        o = jm.apply(p, *args, deterministic=True)
        return o['loss'], o
    (_, jo), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    tm.eval()
    if bf16:
        tm.set_compute_dtype(torch.bfloat16, at_use=True)
    to = tm(*(torch.from_numpy(a) for a in (x, lens, text, tl)))
    to['loss'].backward()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    jg = convert_params(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     jg))
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    return request.param, jo, to, jg, tg


def test_loss_terms_and_gradients(grads):
    dtype, jo, to, jg, tg = grads
    rtol = 1e-5 if dtype == 'float32' else 1e-2
    for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
        assert abs(to[k].item() - float(jo[k])) <= rtol * max(
            abs(float(jo[k])), 1e-3), k
    assert set(tg) == set(jg)
    if dtype == 'float32':
        gmax = max(np.abs(g.numpy()).max() for g in jg.values())
        for n, g in jg.items():
            err = np.abs(tg[n] - g.numpy()).max()
            assert err <= 1e-5 * np.abs(g.numpy()).max() + 1e-5 * gmax, n
    else:
        diff = np.sqrt(sum(((tg[n] - g.numpy()) ** 2).sum()
                           for n, g in jg.items()))
        norm = np.sqrt(sum((g.numpy() ** 2).sum() for g in jg.values()))
        assert diff <= 5e-2 * norm, (diff, norm)


SCHEDULES = {
    'WarmupLR': dict(OPT),
    'AdamW-cosine': {'optimizer': 'AdamW', 'weight_decay': 0.1,
                     'learning_rate': 0.05, 'scheduler': 'CosineWithWarmup',
                     'scheduler_conf': {'warmup_steps': 2, 'T_max': 6}},
    'Momentum-noam': {'optimizer': 'Momentum', 'weight_decay': 1e-3,
                      'learning_rate': 0.1, 'scheduler': 'NoamHoldAnnealing',
                      'scheduler_conf': {'max_steps': 6, 'warmup_steps': 1,
                                         'hold_steps': 2}},
}


@pytest.mark.parametrize('name', list(SCHEDULES))
def test_schedule_matches_jax(name):
    conf = SCHEDULES[name]
    want = jax_scheduler.build_schedule(conf)
    got = scheduler.build_schedule(conf)
    for step in list(range(12)) + [999, 1000, 1001, 5000, 200000]:
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert got(step) == pytest.approx(w, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize('name', list(SCHEDULES))
def test_optimizer_chain_matches_optax(name):
    conf = SCHEDULES[name]
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx, _ = jax_factory.build_optimizer(conf, grad_clip=5.0)
    jp = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(jp)

    @jax.jit
    def jax_update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state
    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.tensor(p)) for p in p0])
    from ppasr_tpu_torch.optimizer.factory import (build_optimizer,
                                                   clip_by_global_norm)
    opt, schedule, clip = build_optimizer(list(module), conf, 5.0)
    for step in range(5):
        scale = 10.0 if step % 2 else 0.3     # clip on odd steps only
        g = [rng.standard_normal(s).astype(np.float32) * scale
             for s in shapes]
        jp, opt_state = jax_update([jnp.asarray(a) for a in g], opt_state,
                                   jp)
        for p, a in zip(module, g):
            p.grad = torch.tensor(a)
        clip_by_global_norm([p.grad for p in module], clip)
        for group in opt.param_groups:
            group['lr'] = schedule(step)
        opt.step()
        for p, w in zip(module, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)


def test_accum_grad_matches_make_train_step():
    # one encoder block and no right-to-left decoder: the scan over
    # micro-steps compiles the model twice, and the accumulation is what
    # this test checks
    enc = dict(ENC, num_blocks=1, **NO_DROP)
    dec = dict(DEC, r_num_blocks=0, **NO_DROP_DEC)
    jm, params, tm = _pair(streaming=False, enc=enc, dec=dec, seed=2)
    conf = {'optimizer': 'Momentum', 'weight_decay': 1e-3,
            'learning_rate': 0.05, 'scheduler': 'CosineWithWarmup',
            'scheduler_conf': {'warmup_steps': 0, 'T_max': 100}}
    tx, _ = jax_factory.build_optimizer(conf, grad_clip=5.0)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params))
    jstep = jax.jit(jax_make_train_step(jm, tx, accum_grad=2))
    x, lens, text, tl = _batch(seed=4, b=4)
    jb = {'speech': x.reshape(2, 2, *x.shape[1:]),
          'speech_lens': lens.reshape(2, 2), 'text': text.reshape(2, 2, -1),
          'text_lens': tl.reshape(2, 2)}
    state = create_train_state(tm, conf, grad_clip=5.0)
    step = make_train_step(accum_grad=2)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jb.items()}
    for i in range(2):
        jstate, jm_metrics = jstep(jstate, jax.tree.map(jnp.asarray, jb),
                                   jax.random.PRNGKey(i))
        metrics = step(state, tb, i)
        for k in ('loss', 'loss_att', 'loss_ctc', 'th_accuracy'):
            assert metrics[k].item() == pytest.approx(
                float(jm_metrics[k]), rel=1e-5, abs=1e-6), k
    assert state.step == 2
    want = convert_params(jax.tree.map(np.asarray, jstate.params))
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_fresh_init_statistics():
    jm = _jax_model(enc=dict(ENC, num_blocks=1))
    key = jax.random.PRNGKey(5)
    params = jax.jit(lambda k: jm.init(
        {'params': k, 'dropout': k, 'chunk': k}, jnp.zeros((1, 64, D)),
        jnp.asarray([64]), jnp.asarray([[1, 2]]), jnp.asarray([2]),
        deterministic=True))(key)
    want = convert_params(jax.tree.map(np.asarray, params))
    tm = ConformerModel(D, V, True, dict(ENC, num_blocks=1), dict(DEC))
    tm.init_weights(torch.Generator().manual_seed(0))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for n, w in want.items():
        w = w.numpy().astype(np.float64)
        g = got[n].detach().numpy().astype(np.float64)
        if np.all(w == w.flat[0]):            # zeros and ones
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        tol = 5 / np.sqrt(w.size) * w.std()
        assert abs(g.mean() - w.mean()) <= tol, n
        assert abs(g.std() - w.std()) <= tol, n
