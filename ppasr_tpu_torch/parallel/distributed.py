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


def world_size() -> int:
    """The process group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier():
    if dist.is_initialized():
        dist.barrier()


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, in place (no gradient); the tensor as it is
    without a process group."""
    if dist.is_initialized():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def all_reduce_sum_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks whose backward sums the ranks' gradients: with
    DDP's average of the parameters' gradients, the gradient of the mean
    of the ranks' losses through a statistic of the global batch."""
    return _AllReduceSum.apply(x)
