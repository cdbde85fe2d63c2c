"""Parallelism across processes (counterpart of ppasr_tpu/parallel/mesh.py
and of ``data_mesh``/``shard_batch``/``replicate`` in
ppasr_tpu/train_state.py): one process per card under ``torchrun``.

- ``distributed.py``: the process group, the collectives with an explicit
  group, and the batch-sharded beam decode;
- ``mesh.py``: the (data, model) grid of process groups and the Megatron
  placement table;
- ``tensor_parallel.py``: the model axis, Megatron tensor parallelism of
  the attention families written with hand collectives.

DistributedDataParallel over the data group is ``train_state.
data_parallel``."""
