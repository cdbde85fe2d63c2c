"""The (data, model) process grid and the Megatron placement table
(counterpart of ppasr_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ``(data, model)`` mesh and lets
GSPMD insert the collectives. The port runs one process per card, so the
grid is a pair of process groups per rank and every collective is written
by hand (``parallel/tensor_parallel.py``):

- ``make_mesh(n_data, n_model)`` over the running process group: rank
  ``d · n_model + m`` is grid point (d, m), the model axis innermost as in
  JAX's ``reshape(n_data, n_model)``. Its ``data_group`` holds the ranks of
  one model index (DDP averages over it), its ``model_group`` those of one
  data index (the tensor-parallel collectives run over it).
- ``param_specs(tree, n_model)``: the sharded dim of every leaf of a flax
  tree (``utils/checkpoint.export_params``), or None where it is
  replicated, leaf for leaf JAX's ``param_shardings(mesh, params,
  tp=True)``:

  | param                                  | sharded dim |
  |----------------------------------------|-------------|
  | linear_q/k/v/pos, w_1, pointwise_conv1 kernel and bias | out |
  | pos_bias_u / pos_bias_v [H, dk]        | 0 (heads)   |
  | linear_out, w_2, pointwise_conv2 kernel | in         |
  | any other kernel or embedding          | last (out)  |
  | row-parallel biases, norms, statistics | replicated  |

  and a leaf whose sharded dim does not divide by ``n_model`` is
  replicated.
- ``shard_params(tree, n_model, index)`` / ``unshard_params(trees,
  specs)``: a
  whole flax tree (numpy) to one model rank's shards and back. The port's
  one layout of its own: ``pointwise_conv1`` [D, 2D] feeds a GLU, and JAX
  shards its output contiguously (at two ranks one would hold every GLU
  "a" column, the other every "b"). The port gives rank r the r-th slice
  of each half, [a_r | b_r], so that the GLU stays on the rank; its
  ``param_specs`` entry is still the last dim, as JAX's table says.
"""
from typing import NamedTuple

import numpy as np
import torch.distributed as dist

COLUMN_PARALLEL = ('linear_q', 'linear_k', 'linear_v', 'linear_pos',
                   'w_1', 'pointwise_conv1')
ROW_PARALLEL = ('linear_out', 'w_2', 'pointwise_conv2')
HEAD_PARAMS = ('pos_bias_u', 'pos_bias_v')
GLU_INPUT = 'pointwise_conv1'


class Mesh(NamedTuple):
    """One rank's place on the (data, model) grid and its two groups."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object


def make_mesh(n_data: int = None, n_model: int = 1) -> Mesh:
    """The grid over the running process group (``n_data`` None: the world
    over ``n_model``). Every rank creates every group, in one order, as
    ``dist.new_group`` requires even of the ranks outside a group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a running process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the "
                         f"{world} ranks")
    data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)]
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, d, m, data_groups[m], model_groups[d])


def _leaf_spec(path: tuple, ndim: int):
    """JAX's ``_leaf_spec`` (ppasr_tpu/parallel/mesh.py:63-85) as the
    sharded dim, or None: matched on the leaf's name and its module's."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else '')
    if name in HEAD_PARAMS:
        return 0
    if name == 'kernel':
        if parent in ROW_PARALLEL:
            return 0 if ndim == 2 else ndim - 2
        return ndim - 1
    if name == 'bias' and parent in COLUMN_PARALLEL and ndim == 1:
        return 0
    if name == 'embedding' and ndim >= 2:
        return ndim - 1
    return None


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(tree: dict, n_model: int) -> dict:
    """The sharded dim of every leaf of ``tree`` over ``n_model`` ranks, or
    None (replicated): ``_leaf_spec``, then JAX's divisibility rule."""
    def spec(path, leaf):
        dim = _leaf_spec(path, np.ndim(leaf))
        if dim is None or np.shape(leaf)[dim] % n_model:
            return None
        return dim
    return _map(spec, tree)


def _shard(path, leaf, dim, n_model, index):
    leaf = np.asarray(leaf)
    if path[-2:-1] == (GLU_INPUT,):
        halves = np.split(leaf, 2, axis=dim)
        return np.concatenate([np.split(h, n_model, axis=dim)[index]
                               for h in halves], axis=dim)
    return np.split(leaf, n_model, axis=dim)[index]


def shard_params(tree: dict, n_model: int, index: int) -> dict:
    """Model rank ``index``'s shards of a whole flax tree (copies)."""
    specs = param_specs(tree, n_model)

    def one(path, leaf):
        dim = _get(specs, path)
        if dim is None:
            return np.array(leaf, copy=True)
        return np.ascontiguousarray(_shard(path, leaf, dim, n_model, index))
    return _map(one, tree)


def unshard_params(trees: list, specs: dict) -> dict:
    """The whole flax tree from the model ranks' shard trees (in model
    index order) and the whole tree's ``param_specs``: the inverse of
    ``shard_params``."""
    def one(path, leaf):
        dim = _get(specs, path)
        if dim is None:
            return np.array(leaf, copy=True)
        parts = [np.asarray(_get(t, path)) for t in trees]
        if path[-2:-1] == (GLU_INPUT,):
            halves = [np.split(p, 2, axis=dim) for p in parts]
            return np.concatenate([h[0] for h in halves]
                                  + [h[1] for h in halves], axis=dim)
        return np.concatenate(parts, axis=dim)
    return _map(one, trees[0])


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
