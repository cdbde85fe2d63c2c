"""One traced run of a cell, as ``run.py --trace 1`` makes it, and its
breakdown by the program's own spans as well as the benchmark's:

    python3 benchmark/tools/program_breakdown.py \
        --workload conformer.train_f32 --seed 7 --seconds 51

prints the run's result line, then one JSON line: the card's idle gaps
named by the innermost span open at each gap's middle, of the benchmark's
spans (``feed``, ``update``, ...) and the program's (``engine.step``,
``train.backward``, ...; ``harness/program.py``) together; the host's
kernel-launch calls and the kernels the card ran in the traced window
(equal where the launch calls the reader matches are all there are); and
the traced tail's counters."""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run as bench  # noqa: E402
from harness import device, program, spec  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args()
    cell = spec.Cell(args.workload)
    device.require_cards(cell.chips)
    runs = []

    class Kept(bench.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)
    bench.Run = Kept
    result = bench.run_cell(cell, args.seed, args.seconds, 1)
    print(json.dumps(result), flush=True)
    run = runs[0]
    p = program.of(run.tracer)
    print(json.dumps({
        'idle_gaps': p.idle_gaps(run.tracer.spans),
        'launch_calls': len(p.launches),
        'kernels': run.tracer.kernel_count(),
        'tail': {k: v for k, v in run.tail.items()
                 if isinstance(v, (int, float))}}), flush=True)


if __name__ == '__main__':
    main()
