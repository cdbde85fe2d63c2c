"""Tensor-parallel harness of the port (no JAX): the cases, their weights
and batches, the train step on a (data, model) grid and the batch-sharded
beam decode, for tests/test_torch_tensor_parallel.py, tests/
test_torch_tensor_parallel_cuda.py and chip_smoke.py's tp phase.

    python -m torch.distributed.run --standalone --nproc_per_node=4 \\
        tests/torch_tp_worker.py SPEC.json

runs, in every rank of one process group, the spec's ``train`` cases in
order (each ``[case, n_data, n_model]``) and then its ``decode``, on the
spec's ``device`` (with ``plain_fbank``, the device frontend on B1's plain
version). The grids DP2×TP2, DP1×TP4 and DP4 are made once, in one
order, whatever the spec asks. Each rank writes ``<out>/<case>_<n_data>x
<n_model>.rank<r>.json`` (``train`` below) and the model-index-0 ranks the
gathered whole parameters beside it (``.params.npz``, torch names);
``decode`` writes ``<out>/decode.rank<r>.json`` and its posteriors. The
same functions run the one-process reference (``mesh`` None).

The cases (``CASES``): JAX's ``_tiny_model`` of tests/
test_sharded_training.py (a Conformer of width 32, 4 heads, 64 FFN units,
2 blocks, kernel 7, a 1 + 1-block decoder, ``reverse_weight`` 0.3,
dropout 0, 20 input features, 64 symbols), not streaming, with 4 decoder
heads instead of 2 (the port shards whole heads); an EfficientConformer
of that width whose conv module carries a BatchNorm (grouped attention and
a strided conv block in layer 0); the streaming Conformer on raw audio
with dropout 0.1 and the device frontend's dither (B1's plain version on
the CPU); and on the card the flagship from its committed checkpoint.
"""
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import make_torch_train_fixture as tf  # noqa: E402  (no JAX at import)
from torch_ddp_worker import PARITY_OPTIMIZER  # noqa: E402

DIM, VOCAB = 20, 64
NO_DROP = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
               attention_dropout_rate=0.0)
NO_DROP_DEC = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                   self_attention_dropout_rate=0.0,
                   src_attention_dropout_rate=0.0)
TINY_ENC = dict(output_size=32, attention_heads=4, linear_units=64,
                num_blocks=2, cnn_module_kernel=7, **NO_DROP)
TINY_DEC = dict(attention_heads=4, linear_units=64, num_blocks=1,
                r_num_blocks=1, **NO_DROP_DEC)
MODEL_CONF = dict(ctc_weight=0.5, lsm_weight=0.1, reverse_weight=0.3)
DROPOUT = 0.1
CASES = {
    'conformer': dict(use_model='conformer', input_dim=DIM,
                      streaming=False, encoder_conf=TINY_ENC,
                      decoder_conf=TINY_DEC),
    'efficient_conformer_bn': dict(
        use_model='efficient_conformer', input_dim=DIM, streaming=False,
        encoder_conf=dict(TINY_ENC, cnn_module_norm='batch_norm',
                          efficient_conf=dict(stride_layer_idx=[0],
                                              stride=[2],
                                              group_layer_idx=[0],
                                              group_size=3)),
        decoder_conf=TINY_DEC),
    'conformer_raw': dict(
        use_model='conformer', input_dim=80, streaming=True, raw=True,
        encoder_conf=dict(TINY_ENC, dropout_rate=DROPOUT,
                          positional_dropout_rate=DROPOUT,
                          attention_dropout_rate=DROPOUT),
        decoder_conf=dict(TINY_DEC, dropout_rate=DROPOUT,
                          positional_dropout_rate=DROPOUT,
                          self_attention_dropout_rate=DROPOUT,
                          src_attention_dropout_rate=DROPOUT)),
    'flagship': dict(raw=True, deterministic=True),
}
GRIDS = ((2, 2), (1, 4), (4, 1))
UPDATES, ACCUM = 2, 2
GRAD_CLIP = 5.0
# the batch-sharded decode: JAX's peaky posteriors (tests/
# test_sharded_decode.py:16-26) and its encoder → decode chain
PEAKY = dict(bsz=8, t=60, v=128, beam_size=5)
CHAIN_ENC = dict(output_size=32, attention_heads=2, linear_units=48,
                 num_blocks=1, cnn_module_kernel=7)
CHAIN_DEC = dict(attention_heads=2, linear_units=48, num_blocks=1,
                 r_num_blocks=1)
CHAIN = dict(input_dim=20, vocab=40, bsz=8, frames=64, beam_size=4)


def peaky_posteriors(bsz, t, v, seed=0):
    """tests/test_sharded_decode.py's generator: mostly blank frames, each
    other frame spiking one symbol."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((bsz, t, v)).astype(np.float32)
    blank_frames = rng.random((bsz, t)) < 0.7
    logits[..., 0] = np.where(blank_frames, 10.0, -2.0)
    spike = rng.integers(1, v, (bsz, t))
    idx = np.arange(t)
    for b in range(bsz):
        logits[b, idx, spike[b]] += np.where(blank_frames[b], 0, 8.0)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return probs / probs.sum(-1, keepdims=True)


def peaky_vocab(v):
    return [chr(ord('a') + i % 26) + str(i) for i in range(v)]


def build(case, device, seed=0):
    """The case's model with its whole weights on ``device``: the seeded
    init (``init_weights``), or the flagship's committed checkpoint."""
    from ppasr_tpu_torch.models.factory import build_model
    from ppasr_tpu_torch.utils.checkpoint import convert_params, load_msgpack
    if case == 'flagship':
        from ppasr_tpu_torch.config import load_config
        conf = load_config(tf.CONFIG)
        model = build_model(
            'conformer', 80, len(vocabulary()), streaming=True,
            encoder_conf=dict(conf.encoder_conf, **NO_DROP),
            decoder_conf=dict(conf.decoder_conf, **NO_DROP_DEC),
            model_conf=dict(conf.model_conf),
            mean_istd_path=os.path.join(ROOT, 'dataset', 'mean_istd.json'))
        model.load_state_dict(convert_params(load_msgpack(tf.CHECKPOINT)),
                              strict=True)
        return model.to(device)
    c = CASES[case]
    model = build_model(c['use_model'], c['input_dim'],
                        len(vocabulary()) if c.get('raw') else VOCAB,
                        streaming=c['streaming'],
                        encoder_conf=dict(c['encoder_conf']),
                        decoder_conf=dict(c['decoder_conf']),
                        model_conf=dict(MODEL_CONF))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device)


def vocabulary():
    import make_torch_smoke_fixture as fx
    return fx.vocabulary()


def batches(case, device):
    """The case's ``UPDATES`` global batches, each a dict of [ACCUM, B,
    ...] tensors: features of 4 utterances a micro-batch (lengths and
    texts of several sizes) for the tiny feature cases, the training
    fixture's 8 utterances as raw audio (4 a micro-batch) for the others."""
    out = []
    for u in range(UPDATES):
        if CASES[case].get('raw'):
            arrays = tf.micro_batches(tf.batch(tf.load()))
            keys = ('wav', 'wav_lens', 'text', 'text_lens')
        else:
            rng = np.random.default_rng(100 + u)
            speech = (rng.standard_normal((ACCUM, 4, 48, DIM)) * 0.3
                      ).astype(np.float32)
            speech_lens = np.array([[48, 41, 36, 45], [40, 48, 33, 47]])
            text_lens = np.array([[4, 3, 2, 4], [1, 4, 3, 2]])
            text = rng.integers(1, VOCAB - 1, (ACCUM, 4, 4)).astype(np.int32)
            text[np.arange(4)[None, None, :] >= text_lens[..., None]] = -1
            arrays = (speech, speech_lens, text, text_lens)
            keys = ('speech', 'speech_lens', 'text', 'text_lens')
        out.append({k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for k, a in zip(keys, arrays)})
    return out


def data_rows(batch, mesh):
    """This rank's contiguous rows of each micro-batch (all without a
    mesh)."""
    if mesh is None:
        return batch
    from ppasr_tpu_torch.parallel.distributed import shard_rows
    rows = shard_rows(next(iter(batch.values())).shape[1], mesh.data_group)
    return {k: v[:, rows] for k, v in batch.items()}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def synchronize(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def train(case, device, mesh=None, seed=7):
    """``UPDATES`` updates of ``make_train_step`` (ACCUM micro-steps, SGD
    with momentum at lr 0.05, the clip at 5) of the case on ``mesh`` (one
    process when None) → (report, the whole parameters as a torch state
    dict on the CPU). The report: per update the loss and gradient norm
    (the metrics), the wall (host clock to a synchronise), the micro-steps'
    stream seeds, B1's launches, and digests of the replicated and the
    sharded parameters."""
    from ppasr_tpu_torch import train_state as ts
    from ppasr_tpu_torch.ops import fbank_cuda
    from ppasr_tpu_torch.ops.frontend import make_device_frontend
    from ppasr_tpu_torch.parallel.tensor_parallel import (gather_params,
                                                          is_sharded,
                                                          shard_module)
    from ppasr_tpu_torch.utils.checkpoint import convert_params
    c = CASES[case]
    model = build(case, device)
    if mesh is not None:
        shard_module(model, mesh)
    state = ts.create_train_state(model, PARITY_OPTIMIZER, GRAD_CLIP)
    if mesh is not None:
        ts.data_parallel(state, c.get('input_dim', 80), mesh)
    frontend = make_device_frontend({'n_mels': 80}, train=True) \
        if c.get('raw') else None
    step = ts.make_train_step(ACCUM, frontend,
                              deterministic=c.get('deterministic', False))
    seeds, rngs_fn = [], ts.micro_rngs

    def recording_rngs(*a, **kw):
        rngs = rngs_fn(*a, **kw)
        seeds.append({k: g.initial_seed() for k, g in rngs.items()})
        return rngs

    losses, norms, walls = [], [], []
    launches = fbank_cuda.launches
    ts.micro_rngs = recording_rngs
    try:
        for u, batch in enumerate(batches(case, device)):
            synchronize(device)
            t0 = time.time()
            metrics = step(state, data_rows(batch, mesh), seed + u)
            losses.append(float(metrics['loss']))
            norms.append(float(metrics['grad_norm']))
            walls.append(time.time() - t0)
    finally:
        ts.micro_rngs = rngs_fn
    params = state.params
    whole = convert_params(gather_params(model))
    report = {
        'losses': losses, 'grad_norms': norms, 'walls': walls,
        'seeds': seeds, 'launches': fbank_cuda.launches - launches,
        'replicated': digest(p for p in params if not is_sharded(p)),
        'sharded': digest(p for p in params if is_sharded(p)),
        'n_sharded': sum(is_sharded(p) for p in params),
        'ddp': state.replica is not None}
    if mesh is not None:
        report.update(data_index=mesh.data_index,
                      model_index=mesh.model_index)
    return report, whole


def chain_model(device):
    """The tiny model of JAX's encoder → decode chain, seeded."""
    from ppasr_tpu_torch.models.factory import build_model
    model = build_model('conformer', CHAIN['input_dim'], CHAIN['vocab'],
                        streaming=False, encoder_conf=dict(CHAIN_ENC),
                        decoder_conf=dict(CHAIN_DEC),
                        model_conf=dict(MODEL_CONF))
    model.init_weights(torch.Generator().manual_seed(3))
    return model.to(device).eval()


def chain_speech():
    return np.random.default_rng(1).standard_normal(
        (CHAIN['bsz'], CHAIN['frames'], CHAIN['input_dim'])).astype(
            np.float32)


def decode_inputs(kind, device, rows=slice(None)):
    """(decoder, probs, logits, lens) of the decode ``kind`` over the batch
    rows ``rows``: 'peaky' (JAX's generator, the logits their logs),
    'chain' (the tiny chain model's encoder on its speech) or 'flagship'
    (the committed flagship on the training fixture's 8 utterances through
    B1, the beam at tests/fixtures/torch_smoke_utts.npz's conf)."""
    from ppasr_tpu_torch.decoders.beam_search_torch import \
        TorchBeamSearchDecoder
    from ppasr_tpu_torch.predict import ieee_float32
    if kind == 'peaky':
        probs = torch.from_numpy(peaky_posteriors(
            PEAKY['bsz'], PEAKY['t'], PEAKY['v'])[rows]).to(device)
        dec = TorchBeamSearchDecoder(peaky_vocab(PEAKY['v']),
                                     beam_size=PEAKY['beam_size'],
                                     device=device)
        lens = torch.full((probs.shape[0],), PEAKY['t'], dtype=torch.int32)
        return dec, probs, probs.log(), lens
    with torch.no_grad(), ieee_float32():
        if kind == 'chain':
            model = chain_model(device)
            speech = torch.from_numpy(chain_speech()[rows]).to(device)
            lens = torch.full((speech.shape[0],), CHAIN['frames'])
            dec = TorchBeamSearchDecoder(
                [str(i) for i in range(CHAIN['vocab'])],
                beam_size=CHAIN['beam_size'], device=device)
        else:
            import make_torch_smoke_fixture as fx
            from ppasr_tpu_torch.ops.frontend import make_device_frontend
            model = build('flagship', device).eval()
            wav, wav_lens = (torch.from_numpy(np.ascontiguousarray(a[rows]))
                             .to(device) for a in tf.batch(tf.load())[:2])
            speech, lens = make_device_frontend({'n_mels': 80})(
                wav, wav_lens, deterministic=True)
            conf = fx.beam_conf(str(np.load(fx.OUT)['beam_conf']))
            dec = TorchBeamSearchDecoder(vocabulary(), device=device,
                                         **conf)
        probs, out_lens = model.get_encoder_out(speech, lens)
        logits, _ = model.get_encoder_logits(speech, lens)
    return dec, probs, logits, out_lens


def decode(kind, device, group):
    """The batch-sharded decode of ``kind`` over ``group``: this rank's
    rows only, from probabilities and from logits → (results, results
    from logits, this rank's probabilities as numpy)."""
    from ppasr_tpu_torch.parallel.distributed import (decode_batch_sharded,
                                                      shard_rows)
    n = {'peaky': PEAKY['bsz'], 'chain': CHAIN['bsz'], 'flagship': 8}[kind]
    dec, probs, logits, lens = decode_inputs(kind, device,
                                             shard_rows(n, group))
    return (decode_batch_sharded(dec, probs, lens, group),
            decode_batch_sharded(dec, logits, lens, group, from_logits=True),
            probs.float().cpu().numpy())


def use_plain_fbank():
    """The device frontend on B1's plain version (``fbank_batch_torch``),
    for a card test to hold the kernel against it inside a step."""
    from ppasr_tpu_torch.ops import frontend
    from ppasr_tpu_torch.ops.fbank_cuda import fbank_batch_torch

    def plain(wavs, lengths, num_mel_bins=80, sample_rate=16000,
              noise=None):
        return fbank_batch_torch(wavs, lengths, sample_rate, num_mel_bins,
                                 noise=noise)
    frontend.fbank_batch = plain


def main(argv=None):
    import torch.distributed as dist

    from ppasr_tpu_torch.ops import fbank_cuda
    from ppasr_tpu_torch.parallel.distributed import init_distributed
    from ppasr_tpu_torch.parallel.mesh import make_mesh
    argv = list(sys.argv[1:] if argv is None else argv)
    with open(argv[0], encoding='utf-8') as f:
        spec = json.load(f)
    out, device = spec['out'], spec.get('device', 'cpu')
    if spec.get('plain_fbank'):
        use_plain_fbank()
    torch.set_num_threads(1)
    # replicas stay bit-equal only where every kernel is deterministic
    torch.backends.cudnn.deterministic = True
    rank, _, _ = init_distributed(use_gpu=device != 'cpu')
    meshes = {grid: make_mesh(*grid) for grid in GRIDS}
    for case, n_data, n_model in spec.get('train', []):
        mesh = meshes[(n_data, n_model)]
        report, whole = train(case, device, mesh)
        name = os.path.join(out, f'{case}_{n_data}x{n_model}')
        with open(f'{name}.rank{rank}.json', 'w', encoding='utf-8') as f:
            json.dump(report, f)
        if mesh.model_index == 0:
            np.savez(f'{name}.rank{rank}.params.npz',
                     **{k: v.numpy() for k, v in whole.items()})
    decode_spec = spec.get('decode')
    if decode_spec:
        launches = fbank_cuda.launches
        report = {}
        for kind in decode_spec:
            results, from_logits, probs = decode(kind, device,
                                                 meshes[(4, 1)].data_group)
            report[kind] = {'results': results, 'from_logits': from_logits}
            np.save(os.path.join(out, f'decode_{kind}.rank{rank}.npy'),
                    probs)
        report['launches'] = fbank_cuda.launches - launches
        with open(os.path.join(out, f'decode.rank{rank}.json'), 'w',
                  encoding='utf-8') as f:
            json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def start(spec: dict, nproc=4):
    """Write ``spec`` into its ``out`` directory and start this worker under
    ``torch.distributed.run --standalone --nproc_per_node=nproc`` in its
    own process group → the ``Popen``; ``finish`` waits for it."""
    import subprocess
    os.makedirs(spec['out'], exist_ok=True)
    path = os.path.join(spec['out'], 'spec.json')
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
              'MASTER_ADDR', 'MASTER_PORT'):
        env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         f'--nproc_per_node={nproc}', os.path.abspath(__file__), path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def finish(proc, timeout=600) -> str:
    """Wait for a ``start``ed worker, killing its process group at
    ``timeout`` → its combined output. Raises on a non-zero exit or at the
    timeout."""
    import signal
    import subprocess
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        raise RuntimeError(f"{proc.args} ran past {timeout} s:\n"
                           f"{text[-6000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args} exited {proc.returncode}:\n"
                           f"{text[-6000:]}")
    return text


def reports(out, name, nproc=4) -> list:
    """The ranks' JSON reports ``<out>/<name>.rank<r>.json``."""
    result = []
    for r in range(nproc):
        with open(os.path.join(out, f'{name}.rank{r}.json'),
                  encoding='utf-8') as f:
            result.append(json.load(f))
    return result


if __name__ == '__main__':
    sys.exit(main())
