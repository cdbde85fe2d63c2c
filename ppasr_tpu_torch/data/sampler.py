"""Sortagrad batch sampler (copy of ppasr_tpu/data/sampler.py:17-64): epoch 0
keeps the manifest's duration-sorted order; later epochs shift by a random
k, group into batches and shuffle whole batches (``_batch_shuffle``, seeded
by the epoch). The distributed sampler comes with DDP (ROADMAP Queue A,
item 1)."""
import random


def _batch_shuffle(indices, batch_size, epoch, clipped=False):
    rng = random.Random(epoch)
    shift_len = rng.randint(0, batch_size - 1)
    body = indices[shift_len:]
    batches = [body[i:i + batch_size]
               for i in range(0, len(body) - batch_size + 1, batch_size)]
    rng.shuffle(batches)
    batch_indices = [idx for batch in batches for idx in batch]
    if not clipped:
        res_len = len(indices) - shift_len - len(batch_indices)
        if res_len > 0:
            batch_indices.extend(indices[-res_len:])
        batch_indices.extend(indices[0:shift_len])
    return batch_indices


class SortagradBatchSampler:
    def __init__(self, dataset_size: int, batch_size: int,
                 drop_last: bool = True, sortagrad: bool = True,
                 shuffle: bool = True):
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.sortagrad = sortagrad
        self.shuffle = shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        indices = list(range(self.dataset_size))
        if self.shuffle and not (self.sortagrad and self.epoch == 0):
            indices = _batch_shuffle(indices, self.batch_size, self.epoch)
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.dataset_size // self.batch_size
        return (self.dataset_size + self.batch_size - 1) // self.batch_size
