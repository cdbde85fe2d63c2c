"""Prefetching data loader: sampler + dataset + collate on worker threads
(counterpart of ppasr_tpu/data/loader.py:15-109). At most ``num_workers +
prefetch_factor`` batches are in flight; the consumer stopping early stops
the producer, and a dataset error is raised in the consumer.

``pad_to=(frames or samples, labels)`` is a constant least pad target
(``dataset_conf.pad_to_max``); a sampler may also yield ``(indices,
(pad_t, pad_u))``, the target of its world batch, and the two combine by
their maximum. A raw dataset on the native loader (``native_raw``) loads
each batch in one ``load_raw_batch`` call on ``num_workers`` C++ threads,
after the in-batch shuffle."""
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from ppasr_tpu_torch.data.dataset import collate_fn


class DataLoader:
    def __init__(self, dataset, batch_sampler, num_workers: int = 4,
                 prefetch_factor: int = 2, time_bucket: int = 16,
                 label_bucket: int = 8, shuffle_in_batch: bool = True,
                 pad_to=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch_factor)
        self.time_bucket = time_bucket
        self.label_bucket = label_bucket
        self.shuffle_in_batch = shuffle_in_batch
        self.pad_to = pad_to

    def __len__(self):
        return len(self.batch_sampler)

    def _load_batch(self, indices):
        pad_to = self.pad_to
        if isinstance(indices, tuple):
            indices, pad_to = indices
            if self.pad_to is not None:
                pad_to = (max(pad_to[0], self.pad_to[0]),
                          max(pad_to[1], self.pad_to[1]))
        if getattr(self.dataset, 'native_raw', False):
            if self.shuffle_in_batch:
                indices = list(indices)
                random.shuffle(indices)
            return self.dataset.load_raw_batch(
                indices, label_bucket=self.label_bucket, pad_to=pad_to,
                n_threads=self.num_workers)
        items = [self.dataset[i] for i in indices]
        return collate_fn(items, self.time_bucket, self.label_bucket,
                          shuffle=self.shuffle_in_batch, pad_to=pad_to)

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch * self.num_workers)
        stop = threading.Event()
        sentinel = object()
        error = []

        def producer():
            max_inflight = self.num_workers + self.prefetch
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending = deque()
                try:
                    it = iter(self.batch_sampler)
                    exhausted = False
                    while not stop.is_set():
                        while not exhausted and len(pending) < max_inflight:
                            try:
                                indices = next(it)
                            except StopIteration:
                                exhausted = True
                                break
                            pending.append(
                                pool.submit(self._load_batch, indices))
                        if not pending:
                            break
                        q.put(pending.popleft().result())
                except Exception as e:  # noqa: BLE001  re-raised below
                    error.append(e)
                finally:
                    for f in pending:
                        f.cancel()
                    q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            if error:
                raise error[0]
        finally:
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)
