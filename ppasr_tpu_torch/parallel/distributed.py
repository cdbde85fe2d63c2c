"""The process group of multi-process training (replaces
``jax.distributed.initialize`` at ppasr_tpu/trainer.py:409-420 and the
data mesh of ppasr_tpu/train_state.py:106-135).

``init_distributed(use_gpu)`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``). When ``WORLD_SIZE`` is set, one included, it starts the
process group and returns ``(rank, world, device)`` with the device
``cuda:LOCAL_RANK`` or the CPU; without it nothing starts and the result
is ``(0, 1, cuda:0 or cpu)``. A failed start raises. The backend is NCCL
on the cards and gloo on the CPU, or where a host runs more ranks than it
has cards (``LOCAL_WORLD_SIZE`` above the count), which NCCL refuses: rank
``LOCAL_RANK`` then runs on card ``LOCAL_RANK mod count``.

Where the JAX package shards one process's batch over its local devices,
the port runs one process per card.

Every collective here takes its process group explicitly (``group``, the
world when None): a (data, model) grid (``parallel/mesh.py``) reduces the
global batch's statistics over its data group and the tensor-parallel
activations over its model group. ``decode_batch_sharded`` is the
batch-sharded beam decode: each rank decodes its own rows and only the
texts and scores cross the ranks.
"""
import os

import torch
import torch.distributed as dist

TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')


def init_distributed(use_gpu: bool = True):
    """Start the process group from torchrun's environment → (rank, world,
    device)."""
    if use_gpu and not torch.cuda.is_available():
        raise RuntimeError("use_gpu=True but torch.cuda.is_available() "
                           "is False; pass use_gpu=False for the CPU")
    if 'WORLD_SIZE' not in os.environ:
        return 0, 1, torch.device('cuda:0' if use_gpu else 'cpu')
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: start "
                           f"the processes with torchrun")
    rank = int(os.environ['RANK'])
    world = int(os.environ['WORLD_SIZE'])
    local = int(os.environ.get('LOCAL_RANK', rank))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    backend = 'gloo'
    device = torch.device('cpu')
    if use_gpu:
        count = torch.cuda.device_count()
        if local_world <= count:
            backend = 'nccl'
        device = torch.device('cuda', local % count)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method='env://', rank=rank,
                                world_size=world)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise RuntimeError("a process group with another rank or size is "
                           "already running")
    return rank, world, device


def world_size(group=None) -> int:
    """The size of ``group`` (the world when None); 1 without a process
    group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def barrier():
    if dist.is_initialized():
        dist.barrier()


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of ``group`` (the world when None), in place (no
    gradient); the tensor as it is without a process group."""
    if dist.is_initialized():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum_with_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of ``group`` (the world when None) whose backward
    sums the ranks' gradients: with DDP's average of the parameters'
    gradients over that group, the gradient of the mean of the ranks'
    losses through a statistic of the global batch."""
    return _AllReduceSum.apply(x, group)


def all_gather(tensor: torch.Tensor, dim: int = 0, group=None):
    """The ranks' tensors of ``group`` (the world when None), each of one
    shape, concatenated along ``dim`` in group-rank order (no gradient)."""
    parts = [torch.empty_like(tensor) for _ in range(world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather_object(obj, group=None) -> list:
    """The ranks' picklable objects of ``group`` (the world when None) in
    group-rank order; ``[obj]`` without a process group."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def shard_rows(n: int, group=None) -> slice:
    """This rank's contiguous rows of a batch of ``n`` split over ``group``
    (the world when None): the first ``n mod size`` ranks take one row
    more, as ``np.array_split`` splits."""
    size = world_size(group)
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    base, extra = divmod(n, size)
    start = rank * base + min(rank, extra)
    return slice(start, start + base + (rank < extra))


def decode_batch_sharded(decoder, posteriors, lens, group=None,
                         from_logits: bool = False) -> list:
    """The batch-sharded beam decode (the counterpart of
    tests/test_sharded_decode.py's posteriors sharded over the data axis):
    every rank of ``group`` (the world when None) decodes its own
    contiguous rows ``posteriors`` [b, T, V] (probabilities, or CTC logits
    with ``from_logits``: ``decode_batch_from_logits``) and ``lens`` [b] on
    its own device with ``decoder`` (a ``TorchBeamSearchDecoder``); only
    the (score, text) results cross the ranks (``all_gather_object``),
    never the posteriors. Returns the whole batch's results in batch order
    (group-rank order, each rank's rows in order)."""
    decode = decoder.decode_batch_from_logits if from_logits \
        else decoder.decode_batch
    local = decode(posteriors, lens) if len(lens) else []
    return [r for part in all_gather_object(local, group) for r in part]
