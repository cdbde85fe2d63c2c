"""The port's ``SortagradDistributedBatchSampler`` (ppasr_tpu_torch/data/
sampler.py) against the JAX package's (ppasr_tpu/data/sampler.py:67-110),
host code on both sides: for world sizes 1, 2 and 4, every rank, epochs
0–3 (epoch 0 keeps the sortagrad order, later ones shuffle whole world
batches), with and without a pad hint, the local index lists and hints are
identical; the ranks' shards are disjoint, together cover every full world
batch, and every rank gets the same hints."""
import numpy as np
import pytest

from ppasr_tpu.data.sampler import \
    SortagradDistributedBatchSampler as JaxSampler
from ppasr_tpu_torch.data.sampler import SortagradDistributedBatchSampler

N, BATCH = 103, 4
DURATIONS = np.random.default_rng(0).uniform(1.0, 9.0, N)


def _hint(global_indices):
    return (int(max(DURATIONS[i] for i in global_indices) * 100) + 4,
            len(global_indices))


def _epoch(cls, world, rank, epoch, hint):
    s = cls(N, BATCH, num_replicas=world, rank=rank,
            pad_hint_fn=_hint if hint else None)
    s.set_epoch(epoch)
    return list(s), len(s)


@pytest.mark.parametrize('hint', [False, True], ids=['plain', 'hint'])
@pytest.mark.parametrize('world', [1, 2, 4])
def test_distributed_sampler_matches_jax(world, hint):
    for epoch in range(4):
        shards, hints = [], []
        for rank in range(world):
            got, n = _epoch(SortagradDistributedBatchSampler, world, rank,
                            epoch, hint)
            want, n_want = _epoch(JaxSampler, world, rank, epoch, hint)
            assert got == want and n == n_want, (world, rank, epoch)
            if hint:
                hints.append([h for _, h in got])
                got = [b for b, _ in got]
            assert all(len(b) == BATCH for b in got)
            shards.append([i for b in got for i in b])
        seen = sum(shards, [])
        world_batch = BATCH * world
        assert len(seen) == len(set(seen)) == (N // world_batch) * world_batch
        if epoch == 0:   # sortagrad: the manifest's order, world batch by
            assert sorted(seen) == list(range(len(seen)))   # world batch
        assert all(h == hints[0] for h in hints)
