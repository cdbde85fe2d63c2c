"""Helpers of the model-zoo parity tests (imports JAX): a port model and
the JAX model of the same family and configuration, the port's seeded
parameters handed to JAX through ``export_params``, and the comparisons
the per-family test files share (offline CTC log-probs on valid frames,
``forward_chunk`` over several chunks with every cache, the training loss
terms and gradient norm, the convert → export round trip)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ppasr_tpu.models.factory import build_model as jax_build_model
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.utils.checkpoint import convert_params, export_params

jax.config.update('jax_default_matmul_precision', 'highest')

D, V = 80, 12
NO_DROPOUT_DEC = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                      self_attention_dropout_rate=0.0,
                      src_attention_dropout_rate=0.0)


def build_pair(use_model, enc, dec=None, streaming=True, model_conf=None,
               seed=0):
    """(port model in eval mode, JAX model, JAX variables): the port draws
    its parameters (``init_weights``), every floating parameter and buffer
    is then moved by N(0, 0.05²) so that no norm, bias or statistic is at
    its trivial value, and ``export_params`` hands them to JAX."""
    tm = build_model(use_model, D, V, streaming=streaming, encoder_conf=enc,
                     decoder_conf=dec, model_conf=model_conf)
    tm.init_weights(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in tm.parameters():
            if p.requires_grad:
                p.add_(0.05 * torch.randn(p.shape, generator=g))
        for name, b in tm.named_buffers():
            if name.endswith('running_mean'):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.endswith('running_var'):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    jm = jax_build_model(use_model, D, V, streaming=streaming,
                         encoder_conf=enc, decoder_conf=dec,
                         model_conf=model_conf)
    return tm.eval(), jm, jax.tree.map(jnp.asarray, export_params(tm))


def inputs(seed=0, t_max=150, lens=(150, 111)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lens), t_max, D)).astype(np.float32)
    return x, np.asarray(lens, np.int32)


def round_trip_is_identity(tm):
    """convert_params ∘ export_params leaves the flax tree as it is (and
    its keys are the port's ``state_dict``'s)."""
    tree = export_params(tm)
    sd = convert_params(tree)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    again = export_params(tm)
    a = jax.tree_util.tree_flatten_with_path(tree)[0]
    b = jax.tree_util.tree_flatten_with_path(again)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=str(p))
    return tree


def offline_log_probs(tm, jm, variables, x, lens):
    """(port, JAX) CTC log-probs and output lengths, full context."""
    want, want_lens = jax.jit(lambda v, x, n: jm.apply(
        v, x, n, method='get_ctc_log_probs'))(variables, jnp.asarray(x),
                                              jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = tm.get_ctc_log_probs(torch.from_numpy(x),
                                             torch.from_numpy(lens))
    return got.numpy(), got_lens.numpy(), np.asarray(want), \
        np.asarray(want_lens)


def assert_valid_close(got, want, lens, tol):
    assert got.shape == want.shape, (got.shape, want.shape)
    for b, n in enumerate(lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=tol,
                                   rtol=0)


def leaves(state):
    """A streaming state's tensors in field order (tuples flattened)."""
    out = []
    for f in state:
        out.extend(f if isinstance(f, tuple) else [f])
    return out


def chunks_match(tm, jm, variables, x, n_chunks, tol, cache=64, ds2=False):
    """Run ``n_chunks`` windows of 67 frames at stride 64 through both
    packages' ``get_encoder_out_chunk`` from a zero state; every chunk's
    posteriors and every leaf of the state (per-scale caches included)
    within ``tol``."""
    b = x.shape[0]
    if ds2:
        js, ts = jm.init_state(b), tm.init_state(b)
        step = jax.jit(lambda v, x, n, st: jm.apply(
            v, x, n, st, method='get_encoder_out_chunk'))
    else:
        js, ts = jm.init_state(b, cache), tm.init_state(b, cache)
        step = jax.jit(lambda v, x, st: jm.apply(
            v, x, st, method='get_encoder_out_chunk'))
    for k in range(n_chunks):
        xs = np.ascontiguousarray(x[:, k * 64:k * 64 + 67])
        if ds2:
            lens = np.full((b,), xs.shape[1], np.int32)
            want, _, js = step(variables, jnp.asarray(xs), jnp.asarray(lens),
                               js)
            with torch.no_grad():
                got, _, ts = tm.get_encoder_out_chunk(
                    torch.from_numpy(xs), torch.from_numpy(lens), ts)
        else:
            want, js = step(variables, jnp.asarray(xs), js)
            with torch.no_grad():
                got, ts = tm.get_encoder_out_chunk(torch.from_numpy(xs), ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=0)
        jl, tl = jax.tree.leaves(js), leaves(ts)
        assert len(jl) == len(tl)
        for a, t in zip(jl, tl):
            assert tuple(a.shape) == tuple(t.shape)
            np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=tol,
                                       rtol=0)
    return ts


def loss_and_grad_norm(tm, jm, variables, x, lens, text, text_lens):
    """({term: (port, JAX)}, (port, JAX) global gradient norm) of the
    training loss with dropout off (port ``eval()``, JAX
    ``deterministic``); the port's norm over the parameters it trains."""
    def f(params):
        out = jm.apply(dict(variables, params=params), jnp.asarray(x),
                       jnp.asarray(lens), jnp.asarray(text),
                       jnp.asarray(text_lens), deterministic=True)
        return out['loss'], out
    (_, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables['params'])
    want_norm = float(jnp.sqrt(sum(jnp.sum(g ** 2)
                                   for g in jax.tree.leaves(grads))))
    tm.zero_grad()
    got = tm(torch.from_numpy(x), torch.from_numpy(lens),
             torch.from_numpy(text).long(), torch.from_numpy(text_lens))
    got['loss'].backward()
    got_norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                    for p in tm.parameters()
                                    if p.grad is not None)))
    terms = {k: (got[k].item(), float(v)) for k, v in want.items()
             if v is not None}
    assert {k for k, v in got.items() if v is not None} == set(terms)
    return terms, (got_norm, want_norm)


TEXT = np.array([[1, 2, 3, 4], [5, 6, -1, -1]], np.int32)
TEXT_LENS = np.array([4, 2], np.int32)
