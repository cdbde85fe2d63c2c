"""On the card, at the training cell's own size: each planted fault of
``test_bench_faults`` comes out not correct on three seeds, and prints the
readings that bound the cell's limits from above. Run on the chip:
``python -m pytest -s -m gpu benchmark/tests``."""
import json

import pytest

import run as bench
from harness import spec
from test_bench_faults import (TRAIN, conformer_cls, half_batch_train,
                               optimizer_skipped, token_train)

SEEDS = (2 ** 31 + 41, 2 ** 32 + 42, 3 ** 20 + 43)


@pytest.mark.gpu
@pytest.mark.parametrize('fault', [half_batch_train, token_train,
                                   optimizer_skipped])
def test_training_faults_fail_at_full_size(fault, card, monkeypatch):
    fault(conformer_cls(), monkeypatch)
    for seed in SEEDS:
        result = bench.run_cell(spec.Cell(TRAIN), seed, 5.0, 0)
        print(TRAIN, fault.__name__, seed,
              json.dumps({k: v['value'] for k, v in result['checks'].items()}))
        assert result['correct'] is False
