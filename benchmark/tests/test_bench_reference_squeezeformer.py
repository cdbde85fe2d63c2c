"""The plain Squeezeformer reference agrees with the port at a tiny size on
the CPU, on the harness's seeded weights over three seeds: the serving
engine over two staggered streams, chunk by chunk, each ending in a flush
whose last window gives an odd number of frames (so an odd count of
half-rate frames goes through the recovery), and a padded batch at full
context.

Tolerance: 1e-6 on every posterior. The two sides compute the same float32
products by two formulations of the cache (the port's ring per layer at
its own rate against PPASR's base-rate cache strided and repeated); on the
CPU they agree to rounding (0 on these seeds). The same test fails where
the reference's weights are rounded to TF32's 10-bit mantissa, the
rounding of the precision below the configuration's, and with either
planted fault: the half-rate blocks given base-rate positions and cache
validity (their stride of 2 left out), or the recovery's skip dropped."""
import copy
import json
from pathlib import Path

import pytest
import torch

from harness import model, spec, traffic, weights
from reference import squeezeformer as ref_sq

BENCH = Path(__file__).resolve().parents[1]
SEEDS = (1, 2 ** 31 + 5, 3 ** 20 + 7)
TOL = 1e-6
CHUNK, LEFT = 16, 2          # a cache of 32 frames: the ring wraps early
PIECE = int(0.16 * traffic.RATE)


def tiny():
    conf = copy.deepcopy(json.loads(
        (BENCH / 'configs' / 'squeezeformer.json').read_text()))
    conf['name'] = 'tiny_squeezeformer'
    conf['encoder_conf'].update(encoder_dim=32, output_size=32,
                                attention_heads=4, num_blocks=6,
                                reduce_idx=2, recover_idx=5,
                                cnn_module_kernel=5)
    conf['decoder_conf'].update(linear_units=32, num_blocks=1,
                                r_num_blocks=1)
    conf['vocab_size'] = 50
    return conf


@pytest.fixture(autouse=True)
def artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(model, 'ARTIFACTS', tmp_path)
    torch.set_num_threads(2)


def tf32_like(W):
    """Each weight rounded to the nearest of TF32's 10-bit mantissa."""
    out = {}
    for k, w in W.items():
        bits = w.contiguous().view(torch.int32)
        out[k] = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return out


# ------------------------------------------------------------ planted faults

def unstrided_half_rate(monkeypatch):
    """After the state is built, every block reads its positions and its
    cache's validity at the base rate."""
    from ppasr_tpu_torch.models.squeezeformer import SqueezeformerEncoder
    monkeypatch.setattr(SqueezeformerEncoder, 'factor', lambda self, i: 1)


def skip_dropped(enc):
    """The recovery's output without the frames pushed at the reduction."""
    saved = {}
    enc.time_reduction_layer.register_forward_pre_hook(
        lambda mod, args: saved.__setitem__('skip', args[0]))

    def drop(mod, args, out):
        skip = saved['skip']
        return out - torch.nn.functional.pad(
            skip, (0, 0, 0, out.shape[1] - skip.shape[1]))
    enc.time_recover_layer.register_forward_hook(drop)


# ------------------------------------------------------------ the engine

def odd_flush_lengths(stream, cache):
    """Two utterance lengths, over 4 windows (so the ring wraps) and a
    quarter second apart, whose last window is a flush of an odd number of
    output frames."""
    def odd(n):
        plan = stream.window_plan(n, PIECE, CHUNK, cache)
        return len(plan) > 4 and plan[-1][2] < stream.plan_win(CHUNK) \
            and plan[-1][3] % 2 == 1
    found = [n for n in range(int(1.3 * traffic.RATE), 4 * traffic.RATE, 797)
             if odd(n)]
    return [next(n for n in found if n - found[0] > traffic.RATE // 4),
            found[0]]


def engine_gap(seed, fault=None, monkeypatch=None, control=False):
    """The largest |p_port − p_ref| over two staggered streams through
    ``StreamingBatchEngine``, and whether the served texts are the greedy
    collapse of the posteriors."""
    from harness import check
    from ppasr_tpu_torch.serving import StreamingBatchEngine
    stream = spec.kind_module('stream')
    conf = tiny()
    pred, W, cmvn = model.build_predictor(
        conf, seed, 'cpu', decoding_chunk_size=CHUNK,
        num_decoding_left_chunks=LEFT)
    cache = pred.cache_size
    engine = StreamingBatchEngine(pred, max_streams=2)
    if fault == 'unstrided':
        unstrided_half_rate(monkeypatch)
    elif fault == 'skip':
        skip_dropped(pred.model.encoder)
    lengths = odd_flush_lengths(stream, cache)
    pcms = traffic.synth_audio(lengths, [-24.0, -30.0], seed, 'cpu')
    utts = [traffic.Utterance(u, u, 0.0, n, -24.0) for u, n in
            enumerate(lengths)]
    for u, pcm in zip(utts, pcms):
        u.pcm = pcm
    got = {0: [], 1: []}
    fed = {}
    step = pred.model.get_encoder_out_chunk

    def captured(xs, state):
        probs, new_state = step(xs, state)
        got[fed['uid']].append(probs[fed['slot']].clone())
        return probs, new_state
    pred.model.get_encoder_out_chunk = captured
    # stream 1 opens after stream 0's third piece; then they alternate
    order = [(0, i) for i in range(3)]
    rest = [[(u, i) for i in range(3 if u == 0 else 0,
                                    len(utts[u].piece_bounds(PIECE)))]
            for u in (0, 1)]
    while rest[0] or rest[1]:
        for u in (0, 1):
            if rest[u]:
                order.append(rest[u].pop(0))
    slots, texts = {}, {}
    for u, i in order:
        bounds = utts[u].piece_bounds(PIECE)
        if i == 0:
            slots[u] = engine.open_stream()
        a, b = bounds[i]
        fed.update(uid=u, slot=slots[u])
        res = engine.feed(slots[u], utts[u].pcm[a:b].tobytes(),
                          is_end=i == len(bounds) - 1)
        if i == len(bounds) - 1:
            texts[u] = res['text']
            engine.close_stream(slots[u])
    ref_W = tf32_like(W) if control else W
    ref_mod = spec.reference_module('squeezeformer')
    vocab = ['<blank>', '<unk>'] + [chr(0x4E00 + j) for j in
                                    range(conf['vocab_size'] - 3)] + ['<eos>']
    worst, served = 0.0, True
    for u in (0, 1):
        plan = stream.window_plan(utts[u].n_samples, PIECE, CHUNK, cache)
        assert len(got[u]) == len(plan)
        ref = stream.reference_stream(
            ref_mod, ref_W, cmvn, conf, cache, utts[u], plan, PIECE, CHUNK,
            conf['preprocess_conf']['target_dB'], tf32=False)
        prog = torch.cat([g[:w[3]] for g, w in zip(got[u], plan)])
        worst = max(worst, (prog - torch.cat(ref)).abs().max().item())
        served &= check.collapse(prog.argmax(-1).tolist(), vocab) == texts[u]
    return worst, served


@pytest.mark.parametrize('seed', SEEDS)
def test_engine_matches_over_staggered_streams(seed):
    worst, served = engine_gap(seed)
    print('sound', seed, worst)
    assert served
    assert worst < TOL


@pytest.mark.parametrize('seed', SEEDS)
def test_tf32_like_reference_is_caught(seed):
    worst, _ = engine_gap(seed, control=True)
    print('tf32-like', seed, worst)
    assert worst > TOL


@pytest.mark.parametrize('fault', ['unstrided', 'skip'])
@pytest.mark.parametrize('seed', SEEDS)
def test_planted_fault_is_caught(seed, fault, monkeypatch):
    worst, _ = engine_gap(seed, fault, monkeypatch)
    print(fault, seed, worst)
    assert worst > TOL


# ------------------------------------------------------------ full context

def offline_gap(seed, fault=None, control=False):
    from ppasr_tpu_torch.models.factory import build_model
    conf = tiny()
    m = build_model(conf['use_model'], conf['input_dim'], conf['vocab_size'],
                    True, conf['encoder_conf'], conf['decoder_conf'],
                    conf['model_conf']).eval()
    W = weights.make_weights(ref_sq.param_shapes(conf), seed, 'cpu')
    missing, unexpected = m.load_state_dict(W, strict=False)
    assert not unexpected and all(k.startswith('decoder.') for k in missing)
    if fault == 'skip':
        skip_dropped(m.encoder)
    mean, istd = weights.make_cmvn(80, seed, 'cpu')
    m.encoder.global_cmvn = None
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(3, 211, 80, generator=g) * 3 + 12
    lens = torch.tensor([211, 150, 37])     # 52, 36 and 8 frames
    with torch.no_grad():
        got, got_lens = m.get_encoder_out((feats - mean) * istd, lens)
        ref, ref_lens = ref_sq.forward(tf32_like(W) if control else W,
                                       (mean, istd), conf, feats, lens)
    assert got_lens.tolist() == ref_lens.tolist()
    return max((got[b, :n] - ref[b, :n]).abs().max().item()
               for b, n in enumerate(ref_lens.tolist()))


@pytest.mark.parametrize('seed', SEEDS)
def test_padded_batch_matches(seed):
    assert offline_gap(seed) < TOL
    assert offline_gap(seed, control=True) > TOL
    assert offline_gap(seed, 'skip') > TOL


def test_reference_imports_neither_jax_nor_the_port():
    src = (BENCH / 'reference' / 'squeezeformer.py').read_text()
    assert 'jax' not in src and 'ppasr_tpu' not in src
    assert [ref_sq.factor(tiny(), i) for i in range(6)] == [1, 1, 2, 2, 2, 1]


def test_chunk_flops_count_the_reference():
    """``flops/squeezeformer.py`` against PyTorch's ``FlopCounterMode`` over
    the reference's chunk step with a full cache, less the cache frames
    its convolution modules recompute (4·(K − 1)·d² a block)."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = spec.flops_module('squeezeformer')
    conf = tiny()
    conf['encoder_conf'].update(encoder_dim=8, output_size=8,
                                attention_heads=2,
                                feed_forward_expansion_factor=2)
    conf['vocab_size'], conf['input_dim'] = 7, 13
    W = weights.make_weights(ref_sq.param_shapes(conf), 1, 'cpu')
    stream = ref_sq.Stream(W, (torch.zeros(13), torch.ones(13)), conf, 8,
                           'cpu')
    enc = conf['encoder_conf']
    recomputed = enc['num_blocks'] * 4 * (enc['cnn_module_kernel'] - 1) * 64
    with torch.no_grad():
        for _ in range(2):      # fill the cache of 8 frames
            stream.step(torch.randn(19, 13))
        for _ in range(2):
            with FlopCounterMode(display=False) as fc:
                stream.step(torch.randn(19, 13))
            assert flops.chunk_flops(conf, 19, 4, 8) \
                == fc.get_total_flops() - recomputed
