"""Data-parallel training across the cell's cards, one process a card, through
the port's own DDP: ``train_state.data_parallel`` (DistributedDataParallel
over NCCL, gloo on the CPU) and ``make_train_step``, which runs the first
``accum_grad`` − 1 micro-steps under ``no_sync`` and all-reduces the summed
gradients once an update. Each rank takes the configuration's batch ×
accum_grad utterances an update; the global batch is ``chips`` times that.

The pool, the augmentation and the per-update seeds are ``kinds/train.py``'s
(loaded through ``spec.kind_module``), made for the global batch: each
update's utterances are padded to its longest, and rank r takes columns
r·B … (r + 1)·B − 1 of each micro-batch, as the port's distributed sampler
deals a world batch of an unsorted epoch, so the ranks' utterances, and
their valid frames and tokens, differ as in a real job.

Rank 0 is this process (``run.py``'s): its clock is the set-up's and its
tracer the run's. It starts ranks 1 … chips − 1 as child processes of this
file, on cards 1 … chips − 1, and meets them at a TCP store on a free
local port; it waits for every rank there in a loop that also watches the
children, and every rank starts its process group with a timeout of
``TIMEOUT_S``. A child that exits before the end makes rank 0 kill the
others and raise; a child whose rank 0 has gone exits. Set-up runs the
``check_updates`` checked updates on every rank and reads after each how
far the ranks' parameters lie apart. In the window rank 0 tells the others
over a gloo group, before each update, whether one more follows. The
ranks are bound to no cores, as a launcher such as torchrun leaves them.

The output check, on rank 0 once the others have left: ``loss_gap``,
``grad_gap`` and ``change_gap`` as in ``kinds/train.py``, of rank 0's state
against ``reference/train_ddp.py`` over the global batch; ``replica_gap``,
the largest |parameter − rank 0's| over every rank after each checked
update (limit 0: DDP keeps the replicas equal).

``train_audio_s_per_s`` counts every rank's audio of the window's completed
updates; the ``flops`` counter is the global batch's over ``chips``, a
card's mean share."""
import argparse
import copy
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def child_command(rank: int, world: int, port: int, payload: str) -> list:
    """The command line of rank ``rank``'s process."""
    return [sys.executable, str(Path(__file__).resolve()), '--rank',
            str(rank), '--world', str(world), '--port', str(port),
            '--spec', payload]


def device_of(kind: str, rank: int):
    if kind == 'cuda':
        torch.cuda.set_device(rank)
        return torch.device('cuda', rank)
    return torch.device('cpu')


def start_group(store, rank, world, device):
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                            store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    # the window's one-bit go/stop, kept off the cards' streams
    return dist.new_group(backend='gloo',
                          timeout=timedelta(seconds=TIMEOUT_S))


class Replica:
    """One rank's model, train state, columns of the pool and step."""

    def __init__(self, conf, mix, seed, rank, world, device):
        from harness import spec, traffic
        from harness.weights import make_cmvn, make_weights, sub_seed
        from reference import train as ref_train
        from ppasr_tpu_torch.models.base import GlobalCMVN
        from ppasr_tpu_torch.models.factory import build_model
        from ppasr_tpu_torch.ops.frontend import make_device_frontend
        from ppasr_tpu_torch.train_state import (create_train_state,
                                                 data_parallel,
                                                 make_train_step)
        train = spec.kind_module('train')
        W = make_weights(ref_train.param_shapes(conf), seed, device)
        cmvn = make_cmvn(conf['input_dim'], seed, device)
        self.model = build_model(conf['use_model'], conf['input_dim'],
                                 conf['vocab_size'], conf['streaming'],
                                 conf['encoder_conf'], conf['decoder_conf'],
                                 conf['model_conf']).to(device)
        with torch.no_grad():
            self.model.load_state_dict(W, strict=True)
        self.model.encoder.global_cmvn = GlobalCMVN(
            *(c.cpu().numpy() for c in cmvn)).to(device)
        del W
        self.state = create_train_state(self.model, conf['optimizer_conf'],
                                        conf['train_conf']['grad_clip'])
        data_parallel(self.state, conf['input_dim'])
        self.step = make_train_step(
            conf['train_conf']['accum_grad'],
            make_device_frontend(conf['preprocess_conf'],
                                 mix['augmentation']))
        b = conf['dataset_conf']['batch_size']
        cols = slice(rank * b, (rank + 1) * b)
        pool = train.pool_batches(global_conf(conf, world), mix, seed,
                                  device)
        # every rank's samples and tokens of each update, for the counters
        self.global_lens = [(batch[1].flatten().tolist(),
                             batch[3].flatten().tolist()) for batch in pool]
        self.batches = [tuple(x[:, cols].contiguous() for x in batch)
                        for batch in pool]
        del pool
        self.seeds = [sub_seed(seed, 10 + u)
                      for u in range(len(self.batches))]
        self.names = [n for n, _ in self.model.named_parameters()]
        self.rate = traffic.RATE

    def update(self, u):
        wav, wav_lens, text, tlens = self.batches[u % len(self.batches)]
        return self.step(self.state, {'wav': wav, 'wav_lens': wav_lens,
                                      'text': text, 'text_lens': tlens},
                         self.seeds[u % len(self.seeds)])

    def replica_gap(self) -> float:
        """The largest |parameter − rank 0's| over every rank."""
        with torch.no_grad():
            flat = torch.cat([p.reshape(-1) for p in self.model.parameters()])
            ref = flat.clone()
            dist.broadcast(ref, 0)
            gap = (flat - ref).abs().max().reshape(1)
            dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap)


def global_conf(conf: dict, world: int) -> dict:
    """The configuration whose batch is the global one."""
    out = copy.deepcopy(conf)
    out['dataset_conf']['batch_size'] *= world
    return out


def go(flag_group, value=None) -> bool:
    """Rank 0 sends ``value`` (one more update or not), the others read
    it."""
    t = torch.tensor([int(bool(value))], dtype=torch.int32)
    dist.broadcast(t, 0, group=flag_group)
    return bool(t.item())


# ------------------------------------------------------------ ranks 1 …

def child_main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--rank', type=int, required=True)
    ap.add_argument('--world', type=int, required=True)
    ap.add_argument('--port', type=int, required=True)
    ap.add_argument('--spec', required=True)
    args = ap.parse_args(argv)
    job = json.loads(args.spec)
    parent = os.getppid()

    def orphaned():
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(0.5)
    threading.Thread(target=orphaned, daemon=True).start()
    device = device_of(job['device'], args.rank)
    store = dist.TCPStore('127.0.0.1', args.port, args.world, False,
                          timeout=timedelta(seconds=TIMEOUT_S))
    store.set(f'ready{args.rank}', '1')
    flags = start_group(store, args.rank, args.world, device)
    conf, mix = job['config'], job['traffic']
    rep = Replica(conf, mix, job['seed'], args.rank, args.world, device)
    for u in range(int(mix['check_updates'])):
        rep.update(u)
        rep.replica_gap()
    u = int(mix['check_updates'])
    while go(flags):
        rep.update(u)
        u += 1
    dist.barrier(group=flags)
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------ rank 0

class Children:
    """Ranks 1 … world − 1 as child processes, and a thread that notices a
    child that exits before the end."""

    def __init__(self, world, port, payload):
        self.procs = [subprocess.Popen(child_command(r, world, port, payload),
                                       stdout=subprocess.DEVNULL)
                      for r in range(1, world)]
        self.done = threading.Event()
        self.failed = None
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while True:
            codes = [p.poll() for p in self.procs]
            for r, code in enumerate(codes, 1):
                if code is not None and (code != 0 or not self.done.is_set()):
                    self.failed = f"rank {r} exited with code {code}"
                    self.kill()
                    return
            if None not in codes:
                return
            time.sleep(0.2)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def raise_if_failed(self):
        if self.failed is not None:
            raise RuntimeError(self.failed)

    def join(self):
        """Wait for every child to exit 0, at most ``TIMEOUT_S``."""
        deadline = time.monotonic() + TIMEOUT_S
        for p in self.procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        self.raise_if_failed()


def rendezvous(store, world, children):
    """Wait until every rank has reached the store, watching the children,
    at most ``TIMEOUT_S``."""
    keys = [f'ready{r}' for r in range(1, world)]
    deadline = time.monotonic() + TIMEOUT_S
    while not store.check(keys):
        children.raise_if_failed()
        if time.monotonic() > deadline:
            raise RuntimeError(f"not every rank reached the store within "
                               f"{TIMEOUT_S} s")
        time.sleep(0.1)


def run(ctx):
    from harness import check, spec
    from harness.weights import make_cmvn, make_weights, sub_seed
    from harness.window import Window
    from reference import fbank
    from reference import train as ref_train
    from reference import train_ddp as ref_ddp
    cell, seed, tracer = ctx.cell, ctx.seed, ctx.tracer
    conf, mix = cell.config, cell.traffic
    world, dev = cell.chips, ctx.device
    train = spec.kind_module('train')
    flops = spec.flops_module(cell.entry['config'])
    n_check = int(mix['check_updates'])

    port = free_port()
    store = dist.TCPStore('127.0.0.1', port, world, True,
                          timeout=timedelta(seconds=TIMEOUT_S),
                          wait_for_workers=False)
    payload = json.dumps({'config': conf, 'traffic': mix, 'seed': seed,
                          'device': dev.type})
    children = Children(world, port, payload)
    try:
        rendezvous(store, world, children)
        flags = start_group(store, 0, world, device_of(dev.type, 0))
        rep = Replica(conf, mix, seed, 0, world, dev)
        losses, gaps, first = [], [], None
        for u in range(n_check):
            losses.append(float(rep.update(u)['loss']))
            gaps.append(rep.replica_gap())
            if u == 0:
                opt = rep.state.optimizer.state
                first = {n: opt[p]['exp_avg'] / 0.1
                         if 'exp_avg' in opt[p] else torch.zeros_like(p)
                         for n, p in zip(rep.names, rep.state.params)}
        after = {n: p.detach().clone()
                 for n, p in rep.model.named_parameters()}
        check.sync(dev)
        audio = [sum(ns) / rep.rate for ns, _ in rep.global_lens]
        per_update = [sum(flops.utterance_train_flops(
            conf, fbank.n_frames(int(n)), int(t)) for n, t in zip(ns, ts))
            / world for ns, ts in rep.global_lens]

        totals = {'updates': 0, 'audio_s': 0.0, 'flops': 0}
        last = {}

        def advance(now):
            children.raise_if_failed()
            if not go(flags, now < ctx.seconds):
                return False
            u = n_check + totals['updates']
            with tracer.span('update'):
                last['metrics'] = rep.update(u)
            totals['updates'] += 1
            totals['audio_s'] += audio[u % len(audio)]
            totals['flops'] += per_update[u % len(per_update)]
            return True
        window = Window(ctx, mix['trace_seconds'], lambda: dict(totals))
        window.run(advance)
        final_loss = float(last['metrics']['loss']) if last else math.nan
        children.done.set()
        dist.barrier(group=flags)
        dist.destroy_process_group()
        children.join()
    finally:
        children.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
    e2e = {'train_audio_s_per_s': totals['audio_s'] / window.seconds}

    # ---------------------------------------------------------------- check
    del rep
    check.release()
    aug = train.augmentation(mix)
    W = make_weights(ref_train.param_shapes(conf), seed, dev)
    cmvn = make_cmvn(conf['input_dim'], seed, dev)
    batches = train.pool_batches(global_conf(conf, world), mix, seed,
                                 dev)[:n_check]
    seeds = [sub_seed(seed, 10 + u) for u in range(n_check)]
    with check.precision(False):
        ref_losses, ref_first, ref_after = ref_ddp.updates(
            W, cmvn, conf, aug, batches, seeds, world)
    if ctx.control:
        with check.precision(True):
            losses, first, after = ref_ddp.updates(
                W, cmvn, conf, aug, batches, seeds, world)
    med = float(np.median([float(g.double().norm())
                           for g in ref_first.values()]))
    moved = {k: float(g.double().norm()) >= 1e-3 * med
             for k, g in ref_first.items()}
    values = {
        'loss_gap': max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                            ref_losses)),
        'grad_gap': train.leaf_gap(first, ref_first),
        'change_gap': train.leaf_gap({k: after[k] - W[k] for k in W},
                                     {k: ref_after[k] - W[k] for k in W},
                                     moved),
        'replica_gap': max(gaps),
    }
    if not math.isfinite(final_loss):
        values['loss_gap'] = math.inf
    return dict(e2e=e2e, head=window.head, tail=window.tail,
                attempted=totals['updates'] + n_check, failed=0,
                values=values, checked=n_check)


if __name__ == '__main__':
    BENCH = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]
    sys.exit(child_main())
