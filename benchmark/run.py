"""Run one cell of the benchmark of ``ppasr_tpu_torch`` once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by name from ``BENCHMARK.json`` and the data
files beside this script. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number of the output check beside its limit (also the last lines of
standard error).

Without a CUDA card, or with fewer than the cell asks for, it exits with
code 2 and prints no result; so it does if JAX or the JAX package is
loaded once the window has closed.
"""
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / 'build' / 'benchmark' / 'cache'
for _var, _sub in (('TRITON_CACHE_DIR', 'triton'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TORCHINDUCTOR_CACHE_DIR', 'inductor')):
    os.environ[_var] = str(CACHE / _sub)
for _var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS'):
    os.environ.setdefault(_var, '2')
sys.path[:0] = [str(BENCH), str(ROOT)]


def process_start() -> float:
    """The process's start on the ``time.time`` clock."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from harness import check, device, spec  # noqa: E402
from harness.trace import Tracer  # noqa: E402


class Run:
    """What a run hands its kind and its metric readers."""

    def __init__(self, cell, seed, seconds, trace, dev='cuda', control=None):
        self.cell, self.seed, self.seconds = cell, seed, float(seconds)
        self.device, self.control = torch.device(dev), control
        self.tracer = Tracer(bool(trace))
        self.trace = None
        self.kind = torch.cuda.get_device_name(0) \
            if self.device.type == 'cuda' else 'cpu'
        self.peaks = device.peaks(self.kind)
        self.setup_s = None
        self.device_record = None
        self.head = self.tail = self.e2e = {}

    def window_opened(self):
        self.setup_s = time.time() - STARTED

    def window_closed(self):
        if self.device.type == 'cuda':
            self.device_record = device.device_record(self.cell.chips)
        else:
            self.device_record = {'platform': 'cpu', 'kind': 'cpu',
                                  'count': 1, 'memory_peak_bytes': 0}


def run_cell(cell, seed, seconds, trace, dev='cuda', control=None) -> dict:
    """One run of ``cell`` → the result object. ``control='tf32'`` puts
    the reference in TF32 in the program's place in the output check (the
    check's control, ``tests/test_bench_control.py``; never in a measured
    run)."""
    run = Run(cell, seed, seconds, trace, dev, control)
    out = spec.kind_module(cell.traffic['kind']).run(run)
    run.head, run.tail, run.e2e = out['head'], out['tail'], out['e2e']
    if trace:
        run.trace = run.tracer
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m['name'])(run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        values = dict(out['e2e'], setup_s=run.setup_s)
        values[f"{cell.traffic['kind']}_memory_gb"] = \
            run.device_record['memory_peak_bytes'] / 1e9
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in cell.end_to_end}
    correct, checks = check.judge(out['values'], cell.limits)
    result = {'correct': correct and out['checked'] > 0,
              'attempted': out['attempted'], 'failed': out['failed'],
              'metrics': metrics, 'device': dict(run.device_record)}
    if trace:
        result['device'].update(busy_s=run.tracer.busy_s,
                                window_s=run.tracer.window_s)
        result['breakdown'] = {'device_ops': run.tracer.device_ops(),
                               'idle_gaps': run.tracer.idle_gaps()}
    result['card'] = device.power_limit() if run.device.type == 'cuda' \
        else 'cpu'
    result['frames_checked'] = out['checked']
    result['checks'] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    try:
        device.require_cards(cell.chips)
    except SystemExit as err:
        print(err, file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, args.trace)
    bad = device.forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 2
    check.print_checks(result['checks'])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
