"""Multi-process training harness of the port (no JAX): the workspace, the
config and a report per rank, for tests/test_torch_ddp.py,
tests/test_torch_ddp_cuda.py and chip_smoke.py's ddp phase.

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        tests/torch_ddp_worker.py REPORT [--seed S] [--no_dither] \\
        -- <python -m ppasr_tpu_torch.train arguments>

runs ``ppasr_tpu_torch.train.main`` with those arguments in every rank
(once, without torchrun), after ``random.seed(S)`` (the loader's in-batch
shuffle and the audio augmentation's draws; with ``num_workers`` 1 they
come in one order). Each rank then writes ``REPORT.rank<r>.json``: its
rank, world size, device and backend, every update's loss (the mean over
the ranks, as logged), its own loss before that mean (``local_losses``,
the mean of its micro-steps' forward losses), gradient norm (after DDP's
average, before the clip), the seeds of every micro-step's random streams
('dropout', 'chunk', 'frontend'), reader cost and batch cost, kernel B1's
launches, the batches the native loader made, the checkpoints it wrote,
the update count, the count of trainable parameters and a sha256 of its
parameters.
``--no_dither`` turns off the training dither of the host fbank and of the
device frontend (which then also skips SpecAugment), so that runs over
other splits of one global batch can agree.
"""
import contextlib
import hashlib
import json
import os
import random
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

VOCAB = os.path.join(ROOT, 'dataset', 'vocabulary.txt')
CMVN = os.path.join(ROOT, 'dataset', 'mean_istd.json')
FLAGSHIP_CONFIG = os.path.join(ROOT, 'configs', 'campaign',
                               'conformer_synth.yml')
AUGMENTATION = os.path.join(ROOT, 'configs', 'augmentation.json')
NO_DROPOUT = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                  attention_dropout_rate=0.0)
NO_DROPOUT_DEC = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                      self_attention_dropout_rate=0.0,
                      src_attention_dropout_rate=0.0)
# the narrow model of the trainer's tests, one encoder block
TINY_ENC = dict(output_size=32, attention_heads=2, linear_units=64,
                num_blocks=1, cnn_module_kernel=7)
TINY_DEC = dict(attention_heads=2, linear_units=64, num_blocks=1,
                r_num_blocks=1)
# the parity runs' optimizer: SGD with momentum, whose update is linear in
# the gradient (Adam's first steps move every element by about lr, whatever
# the gradient's scale), at an lr that moves the weights far above the
# parameter tolerances from the first update (WarmupLR without warm-up:
# lr, then lr/√2)
PARITY_OPTIMIZER = dict(optimizer='Momentum', learning_rate=0.05,
                        scheduler='WarmupLR',
                        scheduler_conf={'warmup_steps': 0, 'min_lr': 1e-5})


def write_corpus(root, n_test=2):
    """The training fixture's eight utterances (tests/fixtures/
    torch_train_batch.npz) and their second halves as 16 WAVs, listed in
    ``<root>/manifest.train``; the first ``n_test`` in
    ``manifest.test``. The fixture's texts are all 4 characters; the
    halves take the last 4, 3 or 2 of them in turn, so that the ranks'
    token counts differ within a global batch of halves."""
    import make_torch_train_fixture as tf
    from ppasr_tpu_torch.data.audio import AudioSegment
    data = tf.load()
    utts = list(zip(tf.pcms(data), (str(t) for t in data['texts'])))
    utts += [(p[len(p) // 2:], t[i % 3:]) for i, (p, t) in enumerate(utts)]
    lines = []
    for i, (pcm, text) in enumerate(utts):
        wav = os.path.join(root, f'u{i}.wav')
        AudioSegment.from_ndarray(pcm).to_wav_file(wav)
        lines.append(json.dumps({'audio_filepath': wav,
                                 'duration': len(pcm) / 16000,
                                 'text': text}, ensure_ascii=False))
    for name, part in (('train', lines), ('test', lines[:n_test])):
        with open(os.path.join(root, f'manifest.{name}'), 'w',
                  encoding='utf-8') as f:
            f.write('\n'.join(part) + '\n')
    return len(utts)


def config(root, tiny=True, dropout=False, **sections):
    """The flagship config (configs/campaign/conformer_synth.yml) pointed at
    ``root``'s corpus, with the committed vocabulary and CMVN, float32,
    greedy evaluation, no probe, one loader thread and a log line per
    update; ``tiny`` narrows it to TINY_ENC/TINY_DEC, ``dropout`` False
    turns its dropouts off; ``sections`` update the named sections."""
    from ppasr_tpu_torch.config import load_config
    conf = json.loads(json.dumps(load_config(FLAGSHIP_CONFIG)))
    if tiny:
        conf['encoder_conf'].update(TINY_ENC)
        conf['decoder_conf'].update(TINY_DEC)
    if not dropout:
        conf['encoder_conf'].update(NO_DROPOUT)
        conf['decoder_conf'].update(NO_DROPOUT_DEC)
    conf['dataset_conf'].update(
        train_manifest=os.path.join(root, 'manifest.train'),
        test_manifest=os.path.join(root, 'manifest.test'),
        dataset_vocab=VOCAB, mean_istd_path=CMVN,
        noise_manifest_path=os.path.join(root, 'manifest.noise'),
        min_duration=0.0, num_workers=1, eval_batch_size=2)
    conf['train_conf'].update(enable_amp=False, log_interval=1,
                              train_probe_size=0, max_epoch=1)
    for name, values in sections.items():
        if isinstance(values, dict):
            conf.setdefault(name, {}).update(values)
        else:
            conf[name] = values
    return conf


def write_config(path, conf):
    """A config dict as the block YAML the port's reader takes."""
    def block(tree, indent):
        lines = []
        for k, v in tree.items():
            pad = ' ' * indent
            if isinstance(v, dict):
                lines.append(f"{pad}{k}:" + (' {}' if not v else ''))
                lines.extend(block(v, indent + 2) if v else [])
            elif isinstance(v, bool):
                lines.append(f"{pad}{k}: {v}")
            else:
                lines.append(f"{pad}{k}: {json.dumps(v, ensure_ascii=False)}")
        return lines
    with open(path, 'w', encoding='utf-8') as f:
        f.write('\n'.join(block(conf, 0)) + '\n')
    return path


@contextlib.contextmanager
def no_dither():
    """The training dither off: the host fbank featurizes as in
    evaluation, and the device frontend is built with ``train=False``."""
    from ppasr_tpu_torch.data.featurizer import audio_featurizer
    from ppasr_tpu_torch.ops import frontend
    init = audio_featurizer.AudioFeaturizer.__init__
    make = frontend.make_device_frontend

    def eval_init(self, *args, **kw):
        init(self, *args, **kw)
        self._train = False

    audio_featurizer.AudioFeaturizer.__init__ = eval_init
    frontend.make_device_frontend = \
        lambda conf, aug=None, train=True: make(conf, aug, train=False)
    try:
        yield
    finally:
        audio_featurizer.AudioFeaturizer.__init__ = init
        frontend.make_device_frontend = make


def param_digest(model) -> str:
    h = hashlib.sha256()
    for name, p in model.state_dict().items():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run(argv, seed=0, dither=True):
    """``ppasr_tpu_torch.train.main(argv)`` in this process after
    ``random.seed(seed)`` → (trainer, state, report)."""
    import torch
    import torch.distributed as dist

    from ppasr_tpu_torch import train as train_cli
    from ppasr_tpu_torch import train_state as state_module
    from ppasr_tpu_torch import trainer as trainer_module
    from ppasr_tpu_torch.data.dataset import ASRDataset
    from ppasr_tpu_torch.ops import fbank_cuda
    from ppasr_tpu_torch.trainer import PPASRTrainer

    trainers, backends, saves, native = [], [], [], [0]
    micro, local_losses, grad_norms, seeds = [], [], [], []
    train, save = PPASRTrainer.train, PPASRTrainer._save_checkpoint
    build = PPASRTrainer._build_model
    make_step = trainer_module.make_train_step
    rngs_fn = state_module.micro_rngs
    load_raw_batch = ASRDataset.load_raw_batch

    def recording_train(self, *a, **kw):
        trainers.append(self)
        state = train(self, *a, **kw)
        backends.append(dist.get_backend() if dist.is_initialized()
                        else None)
        return state

    def recording_save(self, path, state, epoch, *a, best=False, **kw):
        saves.append('best_model' if best else f'epoch_{epoch}')
        return save(self, path, state, epoch, *a, best=best, **kw)

    def hooked_build(self, *a, **kw):
        def record(module, args, out):
            if module.training:
                micro.append(out['loss'].detach().float())
        model = build(self, *a, **kw)
        model.register_forward_hook(record)
        return model

    def recording_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def train_step(*args):
            del micro[:]
            metrics = step(*args)
            local_losses.append(torch.stack(micro).mean())
            grad_norms.append(metrics['grad_norm'])
            return metrics
        return train_step

    def recording_rngs(*a, **kw):
        rngs = rngs_fn(*a, **kw)
        seeds.append({k: g.initial_seed() for k, g in rngs.items()})
        return rngs

    def counting_load(self, *a, **kw):
        native[0] += 1
        return load_raw_batch(self, *a, **kw)

    PPASRTrainer.train = recording_train
    PPASRTrainer._save_checkpoint = recording_save
    PPASRTrainer._build_model = hooked_build
    trainer_module.make_train_step = recording_make_step
    state_module.micro_rngs = recording_rngs
    ASRDataset.load_raw_batch = counting_load
    launches = fbank_cuda.launches
    random.seed(seed)
    try:
        with contextlib.nullcontext() if dither else no_dither():
            state = train_cli.main(argv)
    finally:
        PPASRTrainer.train = train
        PPASRTrainer._save_checkpoint = save
        PPASRTrainer._build_model = build
        trainer_module.make_train_step = make_step
        state_module.micro_rngs = rngs_fn
        ASRDataset.load_raw_batch = load_raw_batch
    trainer = trainers[0]
    report = {
        'rank': trainer.rank, 'world': trainer.world,
        'device': str(trainer.device),
        'backend': backends[0],
        'ddp': state.replica is not None,
        'losses': [float(v) for v in trainer.step_losses],
        'local_losses': [float(v) for v in local_losses],
        'grad_norms': [float(v) for v in grad_norms],
        'stream_seeds': seeds,
        'reader_costs': [c[0] for c in trainer.step_costs],
        'batch_costs': [c[1] for c in trainer.step_costs],
        'launches': fbank_cuda.launches - launches,
        'native_batches': native[0], 'saves': saves, 'step': state.step,
        'n_params': sum(p.numel() for p in state.params),
        'digest': param_digest(state.model)}
    assert not dist.is_initialized()
    return trainer, state, report


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index('--')
    own, train_argv = argv[:split], argv[split + 1:]
    report_path = own[0]
    seed = int(own[own.index('--seed') + 1]) if '--seed' in own else 0
    _, _, report = run(train_argv, seed=seed,
                       dither='--no_dither' not in own)
    with open(f"{report_path}.rank{report['rank']}.json", 'w',
              encoding='utf-8') as f:
        json.dump(report, f)
    return 0


def launch(report_path, train_argv, nproc=None, cwd=None, seed=0,
           dither=True, timeout=600, module=False):
    """Run the worker under ``torch.distributed.run --standalone
    --nproc_per_node=nproc`` (``nproc`` None: a plain process, no
    torchrun), or with ``module`` the CLI ``-m ppasr_tpu_torch.train``
    itself, in its own process group, killed at ``timeout`` → (the ranks'
    reports, combined output). Raises on a non-zero exit."""
    import signal
    import subprocess
    cmd = [sys.executable]
    if nproc is not None:
        cmd += ['-m', 'torch.distributed.run', '--standalone',
                f'--nproc_per_node={nproc}']
    if module:
        cmd += ['-m', 'ppasr_tpu_torch.train', *train_argv]
    else:
        cmd += [os.path.abspath(__file__), report_path, '--seed', str(seed),
                *([] if dither else ['--no_dither']), '--', *train_argv]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
              'MASTER_ADDR', 'MASTER_PORT'):
        env.pop(k, None)
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"{cmd} ran past {timeout} s:\n{out[-6000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} exited {proc.returncode}:\n{out[-6000:]}")
    reports = []
    for r in range(nproc or 1):
        path = f"{report_path}.rank{r}.json"
        if not module:
            with open(path, encoding='utf-8') as f:
                reports.append(json.load(f))
    return reports, out


if __name__ == '__main__':
    sys.exit(main())
