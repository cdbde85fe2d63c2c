"""A rehearsal of ``kinds/train_ddp.py`` on the CPU: four gloo ranks (this
process and three children) at a tiny size run the cell's whole path, set-up,
window and check, and come out correct with the replicas equal; a rank that
fails at its start makes rank 0 kill the others and raise well within the
ranks' timeout, and leaves no child behind. Each case runs under an alarm of
its own (``LIMIT_S``), so a hang fails the test instead of holding the run.
About 20 s on 8 cores.

The cell ``conformer.train_ddp4`` is not in ``BENCHMARK.json`` (its rate
spread too widely between runs on four cards to be admitted; PERF.md §7):
``ENTRY`` is its workload entry, added here to a copy of the file."""
import copy
import json
import signal
import sys
import time

import pytest
import torch

import run as bench
from harness import spec

WORKLOAD = 'conformer.train_ddp4'
ENTRY = {'name': WORKLOAD, 'config': 'conformer', 'traffic': 'train_ddp4',
         'chips': 4,
         'why': "the recipe's update on 4 cards: DDP over NCCL, 16 x accum 4 "
                "unsorted utterances a rank (256 an update), one gradient "
                "all-reduce an update, unequal ranks waiting at the sync"}
LIMIT_S = 240


def ddp_cell(root) -> spec.Cell:
    """The cell, read from a copy of ``BENCHMARK.json`` in ``root`` that
    holds ``ENTRY`` and reports ``train_audio_s_per_s`` in it."""
    bench = spec.load_json(spec.ROOT / 'BENCHMARK.json')
    bench['workloads'].append(ENTRY)
    for m in bench['end_to_end']:
        if m['name'] == 'train_audio_s_per_s':
            m['workloads'].append(WORKLOAD)
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return spec.Cell(WORKLOAD, root=root)


def tiny_cell(root):
    cell = ddp_cell(root)
    conf = copy.deepcopy(cell.config)
    conf['encoder_conf'].update(output_size=32, linear_units=64,
                                num_blocks=2)
    conf['decoder_conf'].update(linear_units=32, num_blocks=1,
                                r_num_blocks=1)
    conf['vocab_size'] = 60
    conf['train_conf']['accum_grad'] = 2
    conf['dataset_conf']['batch_size'] = 3
    cell.config = conf
    cell.traffic['trace_seconds'] = 1.0
    cell.traffic['length_s'].update(median=1.5, max=3.0)
    return cell


@pytest.fixture(autouse=True)
def alarm():
    def expired(signum, frame):
        raise TimeoutError(f"over {LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    torch.set_num_threads(1)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_four_ranks_are_correct_and_equal(tmp_path):
    cell = tiny_cell(tmp_path)
    assert cell.chips == 4
    result = bench.run_cell(cell, 2 ** 31 + 77, 3.0, 0, dev='cpu')
    print({k: v['value'] for k, v in result['checks'].items()})
    assert result['frames_checked'] == 3
    assert result['checks']['replica_gap']['value'] == 0
    assert result['correct'] is True, result['checks']
    assert result['metrics']['train_audio_s_per_s']['value'] > 0


def test_a_failed_rank_ends_the_run(tmp_path, monkeypatch):
    kind = spec.kind_module('train_ddp')
    launch = kind.child_command
    procs = []

    def command(rank, world, port, payload):
        if rank == 2:
            return [sys.executable, '-c', 'import sys; sys.exit(3)']
        return launch(rank, world, port, payload)
    monkeypatch.setattr(kind, 'child_command', command)
    real = kind.Children.__init__

    def kept(self, *args):
        real(self, *args)
        procs.extend(self.procs)
    monkeypatch.setattr(kind.Children, '__init__', kept)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match='rank 2 exited with code 3'):
        kind.run(bench.Run(tiny_cell(tmp_path), 5, 3.0, 0, 'cpu'))
    assert time.monotonic() - t0 < kind.TIMEOUT_S
    assert len(procs) == 3
    for p in procs:
        p.wait(timeout=10)
    assert not torch.distributed.is_initialized()
