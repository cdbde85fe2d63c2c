"""Sortagrad batch samplers (copy of ppasr_tpu/data/sampler.py:17-110).

- ``SortagradBatchSampler``: epoch 0 keeps the manifest's duration-sorted
  order; later epochs shift by a random k, group into batches and shuffle
  whole batches (``_batch_shuffle``, seeded by the epoch).
- ``SortagradDistributedBatchSampler``: the same shuffle at the world
  batch's granularity (``batch_size · num_replicas``, remainders clipped),
  so every rank sees the same sequence of world batches and rank r takes
  slice r of each; with ``pad_hint_fn`` each batch comes as ``(local
  indices, pad_hint_fn(world batch))``, a pad target that every rank
  derives alike.
"""
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


class SortagradDistributedBatchSampler(SortagradBatchSampler):
    def __init__(self, dataset_size: int, batch_size: int,
                 num_replicas: int = 1, rank: int = 0,
                 drop_last: bool = True, sortagrad: bool = True,
                 shuffle: bool = True, pad_hint_fn=None):
        """``pad_hint_fn(global_indices) -> (pad_frames, pad_labels)``."""
        super().__init__(dataset_size, batch_size, drop_last, sortagrad,
                         shuffle)
        self.num_replicas = num_replicas
        self.rank = rank
        self.pad_hint_fn = pad_hint_fn

    def __iter__(self):
        indices = list(range(self.dataset_size))
        if self.shuffle and not (self.sortagrad and self.epoch == 0):
            indices = _batch_shuffle(indices,
                                     self.batch_size * self.num_replicas,
                                     self.epoch, clipped=True)
        world_batch = self.batch_size * self.num_replicas
        usable = (len(indices) // world_batch) * world_batch
        for start in range(0, usable, world_batch):
            global_batch = indices[start:start + world_batch]
            lo = self.rank * self.batch_size
            local = global_batch[lo:lo + self.batch_size]
            if self.pad_hint_fn is not None:
                yield local, self.pad_hint_fn(global_batch)
            else:
                yield local

    def __len__(self):
        world_batch = self.batch_size * self.num_replicas
        n = self.dataset_size // world_batch
        if not self.drop_last and self.dataset_size % world_batch:
            n += 1
        return n
