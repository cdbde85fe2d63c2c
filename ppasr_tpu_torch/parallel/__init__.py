"""Data parallelism across processes (counterpart of the data axis of
ppasr_tpu/parallel/mesh.py and of ``data_mesh``/``shard_batch``/
``replicate`` in ppasr_tpu/train_state.py): one process per card under
``torchrun``, DistributedDataParallel over its process group
(``distributed.py``; the DDP wrapper is ``train_state.data_parallel``)."""
