"""Find the highest stream count a streaming cell sustains: run the cell's
traffic (the committed generator, ``harness/traffic.py``) at each count in
turn, in one process, and print per count the latency percentiles of the
pieces, the failures and whether a backlog grew (the feeding thread's mean
lateness over the last fifth of the window against the first fifth).

    python3 benchmark/tools/sweep_stream.py --workload conformer.stream_rt \
        --counts 12,14,16,18,20,22,24,26 --seconds 25 --seed 7

A count is sustained when the 95th percentile is under the traffic's
``latency_limit_ms``, nothing failed and the lateness did not grow by more
than a piece's duration. The knee is the highest sustained count; the
cell's ``streams`` is four fifths of it, rounded down, and the traffic
file records the knee (``knee_streams``) beside it."""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run as bench  # noqa: E402
from harness import spec  # noqa: E402

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--counts', required=True)
    ap.add_argument('--seconds', type=float, default=15.0)
    ap.add_argument('--seed', type=int, default=7)
    args = ap.parse_args()
    for i, n in enumerate(int(c) for c in args.counts.split(',')):
        cell = spec.Cell(args.workload)
        cell.traffic['streams'] = n
        r = bench.Run(cell, args.seed + i, args.seconds, 0)
        out = spec.kind_module(cell.traffic['kind']).run(r)
        late = np.asarray(out['head']['late_s'])
        fifth = max(len(late) // 5, 1)
        growth = float(late[-fifth:].mean() - late[:fifth].mean())
        limit = cell.traffic['latency_limit_ms']
        row = {'streams': n, 'p95_ms': out['e2e']['stream_latency_p95_ms'],
               'late_p95_ms': float(np.percentile(late, 95) * 1e3),
               'late_growth_ms': growth * 1e3,
               'pieces': out['attempted'], 'failed': out['failed'],
               'tick_ms': out['head']['tick_seconds']
               / max(out['head']['ticks'], 1) * 1e3,
               'windows_per_tick': out['head']['windows']
               / max(out['head']['ticks'], 1),
               'checks': out['values']}
        row['sustained'] = (row['p95_ms'] < limit and not row['failed']
                            and growth < cell.traffic['piece_s'])
        print(json.dumps(row), flush=True)


if __name__ == '__main__':
    main()
