"""The output check's control, on the card: the reference computed in
TF32 (the next precision below the configurations' float32 with TF32 off)
put in the program's place must come out not correct, in each cell at its
own size, on three seeds; the program itself comes out correct on one.
Run on the chip: ``python -m pytest -m gpu benchmark/tests``."""
import json

import pytest

import run as bench
from harness import spec

SEEDS = (2 ** 31 + 17, 2 ** 32 + 18, 3 ** 20 + 19)
SECONDS = 8.0


@pytest.mark.gpu
@pytest.mark.parametrize('workload', [w['name'] for w in
                                      spec.Cell.all_workloads()])
def test_control_fails_and_program_passes(workload, card):
    cell = spec.Cell(workload)
    for seed in SEEDS:
        result = bench.run_cell(cell, seed, SECONDS, 0, control='tf32')
        print(workload, 'control', seed, json.dumps(result['checks']))
        assert result['frames_checked'] > 0
        assert result['correct'] is False, result['checks']
    result = bench.run_cell(cell, SEEDS[0] + 1, SECONDS, 0)
    print(workload, 'program', SEEDS[0] + 1, json.dumps(result['checks']))
    assert result['correct'] is True, result['checks']
